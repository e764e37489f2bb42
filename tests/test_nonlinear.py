"""Quantization-aware nonlinear PGD: gradient planning on packed plans."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import Unicycle
from pint_jax.models.dynamics import unpack_controls
from pint_jax.mpc.costs import (
    combine,
    control_effort_cost,
    goal_cost,
    obstacle_cost,
)
from pint_jax.mpc.nonlinear import QuantizedNonlinearPGD


@pytest.fixture(scope="module")
def model():
    return Unicycle(v_shift=10, w_shift=8)


def test_float_twin_matches_reference_rollout(model):
    rng = np.random.default_rng(0)
    B, T = 8, 30
    ctrl_f = np.stack(
        [
            rng.uniform(-1, 1, (B, T)) * 127 * model.v_scale,
            rng.uniform(-1, 1, (B, T)) * 127 * model.w_scale,
        ],
        axis=-1,
    )
    state0 = rng.uniform(-1, 1, (B, 3))
    got = np.asarray(model.rollout_f32(jnp.asarray(state0, jnp.float32),
                                       jnp.asarray(ctrl_f, jnp.float32)))
    expected = model.reference_rollout(state0, ctrl_f)
    np.testing.assert_allclose(got, expected, rtol=0, atol=5e-4)


def test_nonlinear_pgd_reaches_goal(model):
    solver = QuantizedNonlinearPGD(model, horizon=48, iters=60)
    goal = jnp.asarray([[1.5, 0.7], [-1.2, 0.9]])
    cost_fn = goal_cost(model, goal)
    state0 = jnp.zeros((2, 3), jnp.int32)
    words, states = jax.jit(
        lambda s: solver.solve(s, cost_fn)
    )(state0)
    xy = np.asarray(states)[:, -1, :2] * 2.0**-model.frac_bits
    dist = np.linalg.norm(xy - np.asarray(goal), axis=-1)
    assert dist.max() < 0.25, f"terminal distances {dist}"


def test_nonlinear_pgd_beats_mppi_on_smooth_goal(model):
    """On a smooth cost the gradient planner should land at least as close
    as the sampling planner under a comparable budget."""
    from pint_jax.mpc.mppi import QuantizedMPPI

    goal = jnp.asarray([[1.4, -0.6]])
    cost_fn = goal_cost(model, goal)
    state0 = jnp.zeros((1, 3), jnp.int32)

    solver = QuantizedNonlinearPGD(model, horizon=48, iters=60)
    _, states_g = solver.solve(state0, cost_fn)
    d_grad = np.linalg.norm(
        np.asarray(states_g)[0, -1, :2] * 2.0**-model.frac_bits
        - np.asarray(goal)[0]
    )

    mppi = QuantizedMPPI(model, horizon=48, samples=256, noise_lanes=30)
    cost_mppi = goal_cost(model, goal[:, None, :])
    words, _ = mppi.plan(jax.random.PRNGKey(0), state0, cost_mppi, updates=10)
    lanes = unpack_controls(words)
    ctrl = lanes.reshape(1, mppi.horizon, 2)
    states_m = model.rollout(state0, ctrl)
    d_mppi = np.linalg.norm(
        np.asarray(states_m)[0, -1, :2] * 2.0**-model.frac_bits
        - np.asarray(goal)[0]
    )
    assert d_grad <= d_mppi + 0.05, (d_grad, d_mppi)


def test_nonlinear_closed_loop(model):
    solver = QuantizedNonlinearPGD(
        model, horizon=32, iters=8, step_lanes=8.0, final_lanes=1.0
    )
    goal = jnp.asarray([[1.0, 0.5]])
    cost_fn = goal_cost(model, goal)
    state0 = jnp.zeros((1, 3), jnp.int32)
    states, ctrl = jax.jit(
        lambda s: solver.run_closed_loop(s, cost_fn, ticks=50,
                                         iters_per_tick=6)
    )(state0)
    assert states.shape == (1, 51, 3)
    xy = np.asarray(states)[0, :, :2] * 2.0**-model.frac_bits
    dist = np.linalg.norm(xy - np.asarray(goal)[0], axis=-1)
    assert dist[-1] < 0.35, f"closed-loop terminal distance {dist[-1]}"
    # deterministic
    states2, _ = solver.run_closed_loop(state0, cost_fn, 50, 6)
    np.testing.assert_array_equal(np.asarray(states), np.asarray(states2))


def test_nonlinear_pgd_respects_obstacles(model):
    # obstacle slightly off the path axis: a perfectly symmetric saddle has
    # zero lateral gradient and is the one configuration gradient planners
    # cannot break (MPPI covers that case via sampling noise)
    solver = QuantizedNonlinearPGD(model, horizon=48, iters=80)
    goal = jnp.asarray([[1.6, 0.0]])
    obstacle = (0.8, 0.06)
    cost_fn = combine(
        goal_cost(model, goal),
        obstacle_cost(model, [obstacle], radius=0.3),
        control_effort_cost(),
    )
    state0 = jnp.zeros((1, 3), jnp.int32)
    _, states = solver.solve(state0, cost_fn)
    xy = np.asarray(states)[0, :, :2] * 2.0**-model.frac_bits
    d_obs = np.linalg.norm(xy - np.asarray(obstacle), axis=-1)
    assert d_obs.min() > 0.15
    assert np.linalg.norm(xy[-1] - np.asarray(goal)[0]) < 0.45
