"""Planar quadrotor: fixed-point dynamics + multi-input condensed-QP hover
control in closed loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models.quadrotor import PlanarQuadrotor
from pint_jax.mpc import FixedPointPGD, condense_lti, quantize


@pytest.fixture(scope="module")
def model():
    return PlanarQuadrotor()


def test_hover_is_equilibrium(model):
    """Zero lanes at zero state: gravity exactly cancels hover thrust."""
    state = jnp.zeros((1, 6), jnp.int32)
    z = jnp.zeros((1,), jnp.int32)
    nxt = model.step(state, z, z)
    # ay = total*cos - g = (2*hover)*1 - g; cos_q14(0) = 2^14 exactly?
    # parabola at quarter turn: half=2^14 -> peak exactly 2^14 -> cos=1.0
    resid = np.asarray(nxt)[0]
    assert abs(int(resid[4])) <= 2  # <= 2 LSB from rounding of g/2*2
    assert not resid[[0, 1, 2, 3, 5]].any()


def test_matches_float64_reference(model):
    rng = np.random.default_rng(0)
    B, T = 16, 40
    lanes = rng.integers(-40, 40, size=(B, T, 2), dtype=np.int32)
    state0 = np.zeros((B, 6))
    state0[:, 0] = rng.uniform(-1, 1, B)
    state0[:, 1] = rng.uniform(-1, 1, B)
    s0 = model.to_fixed(state0)

    states = model.rollout(jnp.asarray(s0), jnp.asarray(lanes))
    got = model.to_float(np.asarray(states))
    expected = model.reference_rollout(
        state0, lanes.astype(np.float64) * model.f_scale
    )
    # dominant quantization: the 4-bit pre-shift of the thrust-trig product
    # truncates up to 15 Q16-LSB of thrust -> ~240 LSB (~0.004) accel error
    # per step, integrating into velocity and then position over T steps
    a_err = 240 * 2.0**-model.frac_bits
    tol = a_err * T * model.dt * (1 + T * model.dt) + T * 4 * 2.0**-16
    np.testing.assert_allclose(got, expected, rtol=0, atol=max(tol, 0.02))


def test_hover_mpc_closed_loop(model):
    """Multi-input condensed QP (n=6, m=2) stabilizes the nonlinear
    fixed-point plant from an offset + tilt."""
    A, B = model.hover_lti()
    T = 40
    Q = np.diag([4.0, 4.0, 2.0, 0.5, 0.5, 0.5])
    u_max = 100 * model.f_scale  # +-100 lanes of thrust authority
    qp = condense_lti(A, B, Q, 0.05, 10 * Q, T, np.zeros(6), u_max)
    qqp = quantize(qp)
    assert qqp.u_scale == pytest.approx(u_max / 127)
    solver = FixedPointPGD(qqp, iters=25, error_feedback=True)

    from pint_jax.mpc.controller import LTIController

    controller = LTIController(
        qqp,
        plant_step=lambda s, u: model.step(s, u[..., 0], u[..., 1]),
        inputs_per_step=2,
        iters_per_tick=25,
        error_feedback=True,
    )

    state0 = jnp.asarray(
        model.to_fixed(np.array([[0.6, -0.4, 0.03, 0.0, 0.0, 0.0]]))
    )
    states, applied = jax.jit(
        lambda s: controller.run(s, ticks=160)
    )(state0)
    assert applied.shape == (1, 160, 2)
    traj = model.to_float(np.asarray(states)[0])
    # starts offset ...
    assert abs(traj[0, 0]) >= 0.5
    # ... ends hovering near the origin, level and slow
    assert np.abs(traj[-1, :2]).max() < 0.12, traj[-1]
    assert abs(traj[-1, 2]) < 0.02
    assert np.abs(traj[-1, 3:5]).max() < 0.15
