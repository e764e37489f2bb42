"""Quantized dynamics rollouts vs the float64 reference.

The float64 reference implements the same discrete map (incl. the quadratic
trig), so allowed divergence is pure quantization: bounded accumulation of
<= 1 LSB truncation per step.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models import (
    CONTROL_LAYOUT,
    DoubleIntegrator,
    Unicycle,
    pack_controls,
    unpack_controls,
)


def test_pack_unpack_controls_roundtrip():
    rng = np.random.default_rng(0)
    lanes = rng.integers(-128, 128, size=(16, 48), dtype=np.int32)
    words = pack_controls(jnp.asarray(lanes))
    assert words.shape == (16, 12)
    assert words.dtype == jnp.uint32
    back = unpack_controls(words)
    np.testing.assert_array_equal(np.asarray(back), lanes)


def test_int4_control_plans():
    """Sub-byte plans: 8 x int4 lanes per word (2x denser than int8).

    A quantized-to-int4 plan rolls out within the coarser quantization
    tolerance -- the use case is coarse warm-start plans at half the HBM
    footprint.
    """
    from pint_jax import PackedLayout

    int4 = PackedLayout(*([4] * 8))
    model = DoubleIntegrator()
    rng = np.random.default_rng(7)
    B, T = 16, 48
    lanes8 = rng.integers(-128, 128, size=(B, T), dtype=np.int32)
    # quantize int8 lanes to int4 (step 16)
    lanes4 = np.clip(np.round(lanes8 / 16.0), -8, 7).astype(np.int32)

    words4 = pack_controls(jnp.asarray(lanes4), int4)
    assert words4.shape == (B, T // 8)  # half the words of the int8 plan
    back = unpack_controls(words4, int4)
    np.testing.assert_array_equal(np.asarray(back), lanes4)

    # saturating int4 arithmetic works on the packed plan
    from pint_jax.ops import word as W

    doubled = W.add_signed_saturate(int4, words4, words4)
    lanes_doubled = np.asarray(unpack_controls(doubled, int4))
    np.testing.assert_array_equal(
        lanes_doubled, np.clip(lanes4 * 2, -8, 7)
    )

    # rollout of the dequantized int4 plan tracks the int8 plan coarsely
    states8 = model.rollout(jnp.zeros((B, 2), jnp.int32), jnp.asarray(lanes8))
    states4 = model.rollout(
        jnp.zeros((B, 2), jnp.int32), jnp.asarray(lanes4 * 16)
    )
    v_err = model.to_float(
        np.abs(np.asarray(states8) - np.asarray(states4))[..., 1]
    )
    # per-step control error <= 8 lane units -> velocity drift bounded
    assert v_err.max() <= (T + 1) * 8 * model.u_scale * model.dt + 1e-9


def test_double_integrator_matches_reference():
    model = DoubleIntegrator()
    rng = np.random.default_rng(1)
    B, T = 64, 48
    lanes = rng.integers(-128, 128, size=(B, T), dtype=np.int32)
    state0_f = rng.uniform(-4, 4, size=(B, 2))
    state0_q = model.to_fixed(state0_f)

    states_q = model.rollout(jnp.asarray(state0_q), jnp.asarray(lanes))
    got = model.to_float(states_q)

    controls_f = lanes.astype(np.float64) * model.u_scale
    expected = model.reference_rollout(model.to_float(state0_q), controls_f)

    # <=1 LSB truncation per step in v; v's drift integrates into p:
    # |err_p| <= (T + T^2*dt) * LSB, |err_v| <= T * LSB
    tol = (T + 2 + T * T * model.dt) * 2.0**-model.frac_bits
    np.testing.assert_allclose(got, expected, rtol=0, atol=tol)


def test_double_integrator_packed_rollout_identical():
    model = DoubleIntegrator()
    rng = np.random.default_rng(2)
    B, T = 32, 48
    lanes = rng.integers(-128, 128, size=(B, T), dtype=np.int32)
    state0 = model.to_fixed(rng.uniform(-1, 1, size=(B, 2)))
    direct = model.rollout(jnp.asarray(state0), jnp.asarray(lanes))
    packed = model.rollout_packed(
        jnp.asarray(state0), pack_controls(jnp.asarray(lanes))
    )
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(packed))


def test_double_integrator_constant_accel_analytic():
    # analytic check: from rest with constant accel a, exact discretization
    # gives p_k = a*(k*dt)^2/2 exactly
    model = DoubleIntegrator()
    T = 32
    lane = 64  # a = 64 * u_scale
    a = lane * model.u_scale
    lanes = jnp.full((1, T), lane, dtype=jnp.int32)
    states = model.rollout(jnp.zeros((1, 2), jnp.int32), lanes)
    got = model.to_float(states)[0]
    ks = np.arange(T + 1) * model.dt
    np.testing.assert_allclose(got[:, 1], a * ks, atol=T * 2.0**-16)
    np.testing.assert_allclose(got[:, 0], 0.5 * a * ks**2, atol=T * 2.0**-16)


def test_unicycle_matches_reference():
    model = Unicycle()
    rng = np.random.default_rng(3)
    B, T = 64, 50
    ctrl = rng.integers(-128, 128, size=(B, T, 2), dtype=np.int32)
    x0 = np.concatenate(
        [
            model.to_fixed_xy(rng.uniform(-2, 2, size=(B, 2))),
            model.to_fixed_theta(rng.uniform(0, 1, size=(B, 1))),
        ],
        axis=-1,
    ).astype(np.int32)

    states_q = model.rollout(jnp.asarray(x0), jnp.asarray(ctrl))
    got_xy = model.to_float_xy(np.asarray(states_q)[..., :2])
    got_th = model.to_float_theta(np.asarray(states_q)[..., 2])

    ctrl_f = np.stack(
        [
            ctrl[..., 0].astype(np.float64) * model.v_scale,
            ctrl[..., 1].astype(np.float64) * model.w_scale,
        ],
        axis=-1,
    )
    state0_f = np.concatenate(
        [
            model.to_float_xy(x0[..., :2]),
            model.to_float_theta(x0[..., 2])[..., None],
        ],
        axis=-1,
    )
    expected = model.reference_rollout(state0_f, ctrl_f)

    # truncation of products adds ~2^-16 per step to xy and 2^-16 to theta
    tol = (T + 2) * 2.0**-14
    np.testing.assert_allclose(got_xy, expected[..., :2], atol=tol)
    np.testing.assert_allclose(got_th, expected[..., 2], atol=tol)


def test_unicycle_straight_line():
    # theta = 0: moves along +x at v per second
    model = Unicycle()
    T = 32
    ctrl = jnp.stack(
        [
            jnp.full((1, T), 100, jnp.int32),
            jnp.zeros((1, T), jnp.int32),
        ],
        axis=-1,
    )
    states = model.rollout(jnp.zeros((1, 3), jnp.int32), ctrl)
    xy = model.to_float_xy(np.asarray(states)[0, :, :2])
    v = 100 * model.v_scale
    ts = np.arange(T + 1) * model.dt
    np.testing.assert_allclose(xy[:, 0], v * ts, atol=T * 2.0**-13)
    np.testing.assert_allclose(xy[:, 1], 0.0, atol=T * 2.0**-13)


def test_rollout_jit_and_vmap_scale():
    model = DoubleIntegrator()
    rng = np.random.default_rng(4)
    B, T = 256, 48
    lanes = jnp.asarray(rng.integers(-128, 128, size=(B, T), dtype=np.int32))
    state0 = jnp.zeros((B, 2), jnp.int32)
    f = jax.jit(model.rollout)
    out = f(state0, lanes)
    assert out.shape == (B, T + 1, 2)
    out2 = jax.vmap(model.rollout)(state0[:, None, :], lanes[:, None, :])
    np.testing.assert_array_equal(np.asarray(out), np.asarray(out2[:, 0]))
