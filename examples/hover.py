"""Planar-quadrotor hover recovery: the 6-state multi-input device tier.

A batch of birotors starts displaced and tilted around hover; the
on-device nonlinear SQP (:class:`pint_jax.mpc.DeviceSQP`) re-plans
int8-packed rotor-thrust deltas as ONE XLA program per solve, and a
hard vertical-velocity corridor |vy| <= 0.15 m/s is then enforced with
the fully on-device constrained solver
(:class:`pint_jax.mpc.DeviceConstrainedSQP`) -- the biggest geometry in
the model zoo (n=6 states, m=2 coupled inputs).

Run: python examples/hover.py   (CPU or GPU)
"""

import os
import sys

# run from a checkout without installing: python examples/hover.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pint_jax.models.dynamics import unpack_controls
from pint_jax.models.quadrotor import PlanarQuadrotor
from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP

VY_BOUND = 0.15


def main() -> None:
    model = PlanarQuadrotor()
    dev = DeviceSQP(
        model=model, horizon=16, sqp_iters=4, pgd_iters=30,
        Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
        R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6),
    )
    B = 8
    rng = np.random.default_rng(0)
    # displaced + tilted around hover: [x, y, theta, vx, vy, omega]
    x0 = np.stack(
        [rng.uniform(-0.3, 0.3, B), rng.uniform(-0.3, 0.3, B),
         rng.uniform(-0.03, 0.03, B), rng.uniform(-0.2, 0.2, B),
         rng.uniform(-0.2, 0.2, B), rng.uniform(-0.05, 0.05, B)],
        axis=-1,
    )

    print("== Unconstrained hover recovery (DeviceSQP, n=6, m=2) ==")
    words, plans = dev.solve(x0)
    # roll the true fixed-point plant under the plan's first second
    lanes = np.asarray(unpack_controls(words))[:, : dev.n_dec]
    lanes = ((lanes + 128) % 256 - 128).reshape(B, dev.horizon, 2)
    traj = np.asarray(model.rollout(
        np.stack([model.to_fixed(s) for s in x0]),
        np.asarray(lanes, np.int32),
    ))
    final = model.to_float(traj[:, -1])
    print(f"  start |pos| max {np.abs(x0[:, :2]).max():.3f} m -> "
          f"final |pos| max {np.abs(final[:, :2]).max():.3f} m "
          f"(T = {dev.horizon * model.dt:.2f} s)")

    print(f"== Vertical-velocity corridor |vy| <= {VY_BOUND} m/s "
          "(DeviceConstrainedSQP) ==")
    devc = DeviceConstrainedSQP(
        dev, F=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]],
        lo=-VY_BOUND, hi=VY_BOUND, rho=50.0, alm_outer=3,
    )
    w_c, lam = devc.solve_words(
        devc.init_words(B), np.asarray(x0, np.float32))
    lanes_c = np.asarray(unpack_controls(w_c))[:, : dev.n_dec]
    lanes_c = ((lanes_c + 128) % 256 - 128).astype(np.float64)
    viol_u = devc.violation(
        np.asarray(x0, np.float32),
        ((np.asarray(unpack_controls(words))[:, : dev.n_dec] + 128) % 256
         - 128).astype(np.float64))
    viol_c = devc.violation(np.asarray(x0, np.float32), lanes_c)
    print(f"  unconstrained worst |vy| overshoot: {viol_u.max():.3f} m/s")
    print(f"  constrained   worst violation:      {viol_c.max():.4f} m/s "
          f"(multipliers active: {int(np.abs(np.asarray(lam)).max()) > 0})")
    assert viol_c.max() < 0.02


if __name__ == "__main__":
    main()
