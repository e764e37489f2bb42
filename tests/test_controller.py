"""Closed-loop receding-horizon MPC: regulation to the origin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import DoubleIntegrator
from pint_jax.mpc import condense_double_integrator, quantize
from pint_jax.mpc.controller import RecedingHorizonController


@pytest.fixture(scope="module")
def controller():
    # u_shift=10 -> lane scale 2^-6, box |u| <= 127/64 ~ 1.98
    model = DoubleIntegrator(u_shift=10)
    return RecedingHorizonController.build(
        model, horizon=32, iters_per_tick=12
    )


def test_closed_loop_regulates_to_origin(controller):
    model = controller.model
    x0 = model.to_fixed(np.array([[3.0, 0.0], [-2.0, 1.0], [1.0, -1.5]]))
    states, lanes = jax.jit(
        lambda s: controller.run(s, ticks=220)
    )(jnp.asarray(x0))
    pos = model.to_float(np.asarray(states)[..., 0])
    vel = model.to_float(np.asarray(states)[..., 1])
    # started far away ...
    assert np.abs(pos[:, 0]).max() >= 1.0
    # ... ends near the origin with near-zero velocity
    assert np.abs(pos[:, -1]).max() < 0.15
    assert np.abs(vel[:, -1]).max() < 0.15
    # controls stayed inside the box (int8 lanes)
    assert np.abs(np.asarray(lanes)).max() <= 127


def test_closed_loop_fused_solver_identical(controller):
    """use_fused ticks must produce the exact same closed-loop trajectory."""
    import dataclasses

    fused_ctrl = dataclasses.replace(
        controller, use_fused=True, interpret=True
    )
    model = controller.model
    x0 = jnp.asarray(model.to_fixed(np.array([[2.5, -0.3]])))
    s1, l1 = controller.run(x0, ticks=40)
    s2, l2 = fused_ctrl.run(x0, ticks=40)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_closed_loop_is_deterministic(controller):
    model = controller.model
    x0 = jnp.asarray(model.to_fixed(np.array([[2.0, -0.5]])))
    s1, l1 = controller.run(x0, ticks=50)
    s2, l2 = controller.run(x0, ticks=50)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
