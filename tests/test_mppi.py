"""Quantized MPPI on the unicycle: goal reaching with packed control plans."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import Unicycle
from pint_jax.mpc.mppi import QuantizedMPPI, unicycle_goal_cost


@pytest.fixture(scope="module")
def setup():
    # v_shift=10: max speed ~2 units/s; w_shift=8: max ~0.5 turns/s
    model = Unicycle(v_shift=10, w_shift=8)
    mppi = QuantizedMPPI(model, horizon=40, samples=256, noise_lanes=30)
    return model, mppi


def test_mppi_reaches_goal(setup):
    model, mppi = setup
    goal = jnp.asarray([[1.5, 0.8], [-1.0, 1.2]])
    cost_fn = unicycle_goal_cost(model, goal[:, None, :])
    state0 = jnp.zeros((2, 3), jnp.int32)
    key = jax.random.PRNGKey(0)
    words, best = jax.jit(
        lambda k, s: mppi.plan(k, s, cost_fn, updates=10)
    )(key, state0)

    # roll out the final nominal plan and check terminal distance
    from pint_jax.models.dynamics import unpack_controls

    lanes = unpack_controls(words)
    ctrl = lanes.reshape(2, mppi.horizon, 2)
    states = model.rollout(state0, ctrl)
    xy = np.asarray(states)[..., -1, :2] * 2.0**-model.frac_bits
    dist = np.linalg.norm(xy - np.asarray(goal), axis=-1)
    # started ~1.7 away; quantized MPPI should close most of the distance
    assert dist.max() < 0.5, f"terminal distances {dist}"


def test_mppi_cost_decreases(setup):
    model, mppi = setup
    goal = jnp.asarray([[1.0, 0.5]])
    cost_fn = unicycle_goal_cost(model, goal[:, None, :])
    state0 = jnp.zeros((1, 3), jnp.int32)
    key = jax.random.PRNGKey(1)

    words = mppi.init_words(1)
    costs = []
    for i in range(6):
        words, best = mppi.step(
            jax.random.fold_in(key, i), words, state0, cost_fn
        )
        costs.append(float(best[0]))
    assert costs[-1] < costs[0]


def test_mppi_closed_loop_reaches_goal(setup):
    model, mppi = setup
    goal = jnp.asarray([[1.2, 0.6]])
    cost_fn = unicycle_goal_cost(model, goal[:, None, :])
    state0 = jnp.zeros((1, 3), jnp.int32)
    states, ctrl = jax.jit(
        lambda k, s: mppi.run_closed_loop(
            k, s, cost_fn, ticks=60, updates_per_tick=2
        )
    )(jax.random.PRNGKey(5), state0)
    assert states.shape == (1, 61, 3)
    assert ctrl.shape == (1, 60, 2)
    xy = np.asarray(states)[0, :, :2] * 2.0**-model.frac_bits
    d0 = np.linalg.norm(xy[0] - np.asarray(goal)[0])
    dT = np.linalg.norm(xy[-1] - np.asarray(goal)[0])
    assert dT < 0.45, f"closed-loop terminal distance {dT} (start {d0})"


def test_mppi_controls_stay_in_box(setup):
    model, mppi = setup
    goal = jnp.asarray([[5.0, 5.0]])  # far goal saturates controls
    cost_fn = unicycle_goal_cost(model, goal[:, None, :])
    state0 = jnp.zeros((1, 3), jnp.int32)
    words, _ = mppi.plan(jax.random.PRNGKey(2), state0, cost_fn, updates=5)
    from pint_jax.models.dynamics import unpack_controls

    lanes = np.asarray(unpack_controls(words))
    assert lanes.max() <= 127 and lanes.min() >= -128
