"""Corridor-bounded unicycle: fully on-device constrained nonlinear MPC.

Drives a batch of unicycles toward a goal a unit ahead while holding a
hard lateral corridor |y| <= 0.05 -- the whole pipeline (linearize,
condense, constraint stacking, quantization, integer ALM) as one XLA
program per solve (:class:`pint_jax.mpc.DeviceConstrainedSQP`), then the
same solver behind the warm-started serving endpoint
(:class:`pint_jax.serving.ConstrainedRTIService`) in closed loop.

Run: python examples/corridor.py   (CPU or GPU)
"""

import os
import sys

# run from a checkout without installing: python examples/corridor.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP
from pint_jax.models.dynamics import unpack_controls
from pint_jax.serving import ConstrainedRTIService

BOUND = 0.05


def main() -> None:
    csqp = DeviceConstrainedSQP(
        DeviceSQP(
            horizon=32, sqp_iters=4, pgd_iters=30,
            x_ref=np.array([1.0, 0.0, 0.0]),
        ),
        F=[[0.0, 1.0, 0.0]],        # lateral position
        lo=-BOUND, hi=BOUND, rho=100.0, alm_outer=3,
    )

    # -- one-shot planning: headings that would swing far outside the
    #    corridor if unconstrained
    x0 = np.array(
        [[0.0, 0.0, 0.9], [0.0, 0.0, -0.9], [0.0, 0.0, 0.3]], np.float32
    )
    words, lam = csqp.solve_words(csqp.init_words(3), x0)
    lanes = np.asarray(unpack_controls(words), np.int64)
    lanes = ((lanes + 128) % 256 - 128).astype(np.float64)
    viol = csqp.violation(x0, lanes)
    print("== one-shot constrained plans ==")
    print(f"max corridor violation per problem: {np.round(viol, 4)}")
    print(f"multipliers active: {int(np.abs(np.asarray(lam)).max()) > 0}")

    # -- closed loop through the serving endpoint (1 RTI per tick)
    print("\n== closed loop (ConstrainedRTIService, 1 RTI/tick) ==")
    svc = ConstrainedRTIService(
        DeviceConstrainedSQP(
            DeviceSQP(
                horizon=16, sqp_iters=1, pgd_iters=12,
                x_ref=np.array([1.0, 0.0, 0.0]),
            ),
            F=[[0.0, 1.0, 0.0]], lo=-BOUND, hi=BOUND, rho=100.0,
            alm_outer=2,
        ),
        batch=3,
    )
    model = svc.csqp.dev.model
    state = x0.copy()
    worst_y = 0.0
    for _ in range(48):
        u = svc.solve(state)
        traj = model.rollout_f32(
            jnp.asarray(state), jnp.asarray(u[:, None, :], jnp.float32)
        )
        state = np.asarray(traj[:, 1])
        worst_y = max(worst_y, float(np.abs(state[:, 1]).max()))
    print(f"worst |y| over 48 ticks: {worst_y:.4f}  (corridor {BOUND})")
    print(f"final x positions: {np.round(state[:, 0], 3)}  (goal 1.0)")
    print(f"ticks={svc.stats.ticks} resets={svc.stats.resets}")


if __name__ == "__main__":
    main()
