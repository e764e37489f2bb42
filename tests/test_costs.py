"""MPPI cost library: obstacle avoidance steers trajectories around."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import Unicycle
from pint_jax.mpc.costs import (
    combine,
    control_effort_cost,
    control_rate_cost,
    goal_cost,
    obstacle_cost,
)
from pint_jax.mpc.mppi import QuantizedMPPI


@pytest.fixture(scope="module")
def setup():
    model = Unicycle(v_shift=10, w_shift=8)
    mppi = QuantizedMPPI(model, horizon=48, samples=384, noise_lanes=30)
    return model, mppi


def test_obstacle_cost_penalizes_inside():
    model = Unicycle()
    c = obstacle_cost(model, [(1.0, 0.0)], radius=0.5, weight=100.0)
    inside = model.to_fixed_xy(np.array([[1.0, 0.0]]))
    outside = model.to_fixed_xy(np.array([[3.0, 3.0]]))
    st_in = np.concatenate([inside, [[0]]], axis=-1)[None].astype(np.int32)
    st_out = np.concatenate([outside, [[0]]], axis=-1)[None].astype(np.int32)
    ctrl = np.zeros((1, 1, 2), np.int32)
    assert float(c(jnp.asarray(st_in), jnp.asarray(ctrl))[0]) > 50
    assert float(c(jnp.asarray(st_out), jnp.asarray(ctrl))[0]) == 0.0


def test_mppi_avoids_obstacle(setup):
    model, mppi = setup
    goal = np.array([[1.6, 0.0]])
    obstacle = (0.8, 0.0)          # right on the straight-line path
    radius = 0.3
    cost_fn = combine(
        goal_cost(model, goal[:, None, :]),
        obstacle_cost(model, [obstacle], radius=radius),
        control_effort_cost(),
        control_rate_cost(1e-4),
    )
    state0 = jnp.zeros((1, 3), jnp.int32)
    words, _ = jax.jit(
        lambda k, s: mppi.plan(k, s, cost_fn, updates=25)
    )(jax.random.PRNGKey(0), state0)

    from pint_jax.models.dynamics import unpack_controls

    lanes = unpack_controls(words)
    ctrl = lanes.reshape(1, mppi.horizon, 2)
    states = model.rollout(state0, ctrl)
    xy = np.asarray(states)[0, :, :2] * 2.0**-model.frac_bits

    # reaches the goal region ...
    dist_goal = np.linalg.norm(xy[-1] - goal[0])
    assert dist_goal < 0.5, f"terminal distance {dist_goal}"
    # ... without entering the obstacle core
    d_obs = np.linalg.norm(xy - np.asarray(obstacle), axis=-1)
    assert d_obs.min() > 0.55 * radius, f"min obstacle distance {d_obs.min()}"
