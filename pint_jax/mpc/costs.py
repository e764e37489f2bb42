"""Composable trajectory costs for the sampling MPC (MPPI) stack.

Costs consume fixed-point trajectories (int32 states) and int32 control
lanes and return float32 scores -- cost shaping is the one place floats are
appropriate (softmax weighting needs them; the dynamics stay integer-exact).
Each factory returns ``cost(states, controls) -> (...)`` matching the MPPI
contract, and :func:`combine` sums any number of them.
"""

from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import Unicycle

Array = jax.Array
CostFn = Callable[[Array, Array], Array]

__all__ = [
    "combine",
    "goal_cost",
    "obstacle_cost",
    "control_effort_cost",
    "control_rate_cost",
]


def combine(*costs: CostFn) -> CostFn:
    def fn(states, controls):
        total = None
        for c in costs:
            v = c(states, controls)
            total = v if total is None else total + v
        return total

    return fn


def _xy(model, states) -> Array:
    """Physical-unit xy from either fixed-point (int) or physical (float)
    trajectories, so the same cost functions drive the quantized rollouts,
    the MPPI scorer, and the differentiable float32 twin."""
    xy = states[..., :2]
    if jnp.issubdtype(xy.dtype, jnp.integer):
        return xy.astype(jnp.float32) * np.float32(2.0**-model.frac_bits)
    return xy.astype(jnp.float32)


def goal_cost(
    model: Unicycle, goal_xy, terminal_weight: float = 20.0
) -> CostFn:
    """Running + terminal squared distance to a goal point."""

    def fn(states, controls):
        xy = _xy(model, states)
        goal = jnp.asarray(goal_xy, jnp.float32)[..., None, :]
        d2 = jnp.sum((xy - goal) ** 2, axis=-1)
        return jnp.sum(d2[..., 1:], axis=-1) + terminal_weight * d2[..., -1]

    return fn


def obstacle_cost(
    model: Unicycle,
    centers_xy: Sequence,        # (K, 2) obstacle centers, physical units
    radius: float,
    weight: float = 200.0,
) -> CostFn:
    """Soft-barrier penalty for entering circular obstacles: sum over time
    and obstacles of ``weight * max(0, 1 - d/r)^2``."""
    centers = np.asarray(centers_xy, np.float32).reshape(-1, 2)

    def fn(states, controls):
        xy = _xy(model, states)                       # (..., T+1, 2)
        d = jnp.linalg.norm(
            xy[..., None, :] - centers, axis=-1       # (..., T+1, K)
        )
        pen = jnp.maximum(0.0, 1.0 - d / np.float32(radius))
        return weight * jnp.sum(pen * pen, axis=(-2, -1))

    return fn


def control_effort_cost(weight: float = 1e-4) -> CostFn:
    """Quadratic penalty on control lane magnitudes."""

    def fn(states, controls):
        return weight * jnp.sum(
            controls.astype(jnp.float32) ** 2, axis=(-2, -1)
        )

    return fn


def control_rate_cost(weight: float = 1e-3) -> CostFn:
    """Penalty on step-to-step control changes (smoothness)."""

    def fn(states, controls):
        dc = jnp.diff(controls.astype(jnp.float32), axis=-2)
        return weight * jnp.sum(dc * dc, axis=(-2, -1))

    return fn
