"""Pendulum swing-up: quantized SQP planning + real-time-iteration tracking.

The full nonlinear-MPC pipeline on int8 packed plans:

1. **Plan** (offline): a long-horizon quantized SQP
   (:class:`pint_jax.mpc.QuantizedSQP`) pumps the torque-limited pendulum
   from hanging to upright -- the torque ceiling is below peak gravity
   torque, so the solver must discover energy pumping.
2. **Track** (online): a short-horizon quantized SQP inside
   :class:`pint_jax.mpc.SQPController` follows the planned state trajectory
   through the *fixed-point plant* with one real-time iteration per tick
   and balances at the top.  The tracking horizon is deliberately short:
   condensing an exponentially unstable plant conditions like
   e^(2*lambda*T).

Run: python examples/swingup.py   (CPU or GPU)
"""

import os
import sys

# run from a checkout without installing: python examples/swingup.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from pint_jax.models import Pendulum
from pint_jax.mpc import QuantizedSQP, SQPController


def main() -> None:
    model = Pendulum(u_shift=10)
    print(
        f"pendulum: gravity gain {model.k_g} turns/s^2, torque ceiling "
        f"{model.u_max:.2f} (underactuated: {model.u_max < model.k_g})"
    )

    # -- 1. offline swing-up plan (hanging, at rest -> upright) -------------
    planner = QuantizedSQP(
        model=model, horizon=128, sqp_iters=8, pgd_iters=60,
        Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
        qf_scale=80.0, x_ref=np.zeros(2),
    )
    x0 = np.array([[0.5, 0.0]])  # theta in turns from upright: hanging
    plan_words, costs = planner.solve(x0)
    plan = planner.plan_phys(plan_words)
    ref_traj = model.reference_rollout(x0[0], plan[0])
    u = plan[0, :, 0]
    reversals = int(
        np.sum(np.abs(np.diff(np.sign(u[np.abs(u) > 0.05]))) > 0)
    )
    print(
        f"plan: cost {costs[0, 0]:.1f} -> {costs[0, -1]:.1f}, "
        f"{reversals} torque reversals (pumping), "
        f"endpoint theta={ref_traj[-1, 0]:+.3f} turns"
    )

    # -- 2. online tracking through the quantized plant ---------------------
    ticks = 192
    x_ref_traj = np.concatenate(
        [ref_traj, np.zeros((ticks + 16 - ref_traj.shape[0], 2))]
    )
    tracker = QuantizedSQP(
        model=model, horizon=16, sqp_iters=1, pgd_iters=40,
        Q=np.diag([1.0, 0.3]), R=np.array([[0.01]]),
        qf_scale=20.0, x_ref=np.zeros(2), pad_to=16,
    )
    controller = SQPController(tracker, iters_per_tick=1)
    states, applied = controller.run(x0, ticks=ticks, x_ref_traj=x_ref_traj)
    traj = model.to_float(states)[0]
    print(
        f"closed loop ({ticks} ticks, 1 RTI/tick): "
        f"final theta={traj[-1, 0]:+.4f}, omega={traj[-1, 1]:+.4f}"
    )
    bars = "".join(
        "#" if abs(t) < 0.05 else ("+" if t > 0 else "-")
        for t in traj[:: max(1, ticks // 64), 0]
    )
    print(f"|theta| timeline (#=upright): {bars}")
    assert abs(traj[-1, 0]) < 0.02, "did not balance"
    print("swing-up: balanced upright")


if __name__ == "__main__":
    main()
