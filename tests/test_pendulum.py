"""Torque-limited pendulum family + SQP swing-up (the underactuated
second-order planning benchmark)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import Pendulum, pack_controls
from pint_jax.mpc import QuantizedSQP


@pytest.fixture(scope="module")
def model():
    return Pendulum()


def test_quantized_rollout_matches_reference(model):
    rng = np.random.default_rng(0)
    lanes = rng.integers(-127, 128, (16, 64), dtype=np.int64).astype(np.int32)
    th0 = rng.uniform(-0.5, 0.5, 16)
    om0 = rng.uniform(-1.0, 1.0, 16)
    x0 = np.stack([th0, om0], axis=-1)
    fp = model.rollout(jnp.asarray(model.to_fixed(x0)), jnp.asarray(lanes))
    got = model.to_float(np.asarray(fp))
    exp = model.reference_rollout(x0, lanes[..., None] * model.u_scale)
    # truncating shifts lose <= 1 LSB per add; omega errors integrate into
    # theta over T steps
    T = 64
    tol = 4 * T * T * 2.0**-16
    assert np.abs(got - exp).max() <= tol


def test_rollout_packed_matches_unpacked(model):
    rng = np.random.default_rng(1)
    lanes = rng.integers(-127, 128, (8, 32), dtype=np.int64).astype(np.int32)
    x0 = jnp.zeros((8, 2), jnp.int32)
    a = model.rollout(x0, jnp.asarray(lanes))
    b = model.rollout_packed(x0, pack_controls(jnp.asarray(lanes)))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_theta_wraps_mod_turn(model):
    """Q16 turns wrap: a full-turn offset changes nothing in the torque."""
    x0a = jnp.asarray([[0, 1 << 14]], jnp.int32)            # omega > 0
    x0b = jnp.asarray([[1 << 16, 1 << 14]], jnp.int32)      # +1 full turn
    lanes = jnp.full((1, 16), 20, jnp.int32)
    a = np.asarray(model.rollout(x0a, lanes))
    b = np.asarray(model.rollout(x0b, lanes))
    np.testing.assert_array_equal(a[..., 1], b[..., 1])     # same omega
    np.testing.assert_array_equal(a[..., 0] + (1 << 16), b[..., 0])


def test_linearize_vs_finite_differences(model):
    rng = np.random.default_rng(2)
    states = np.stack(
        [rng.uniform(-0.8, 0.8, 24), rng.uniform(-1.5, 1.5, 24)], axis=-1
    )
    controls = rng.uniform(-0.9, 0.9, (24, 1))
    A, B = model.linearize(states, controls)

    def step(x, u):
        return model.reference_rollout(x, u[None, :])[1]

    eps = 1e-7
    for i in range(24):
        for j in range(2):
            e = np.zeros(2)
            e[j] = eps
            col = (
                step(states[i] + e, controls[i])
                - step(states[i] - e, controls[i])
            ) / (2 * eps)
            np.testing.assert_allclose(A[i, :, j], col, atol=1e-5)
        e = np.array([eps])
        col = (
            step(states[i], controls[i] + e)
            - step(states[i], controls[i] - e)
        ) / (2 * eps)
        np.testing.assert_allclose(B[i, :, 0], col, atol=1e-5)


# -- SQP swing-up -------------------------------------------------------------


@pytest.fixture(scope="module")
def swingup(model):
    return QuantizedSQP(
        model=model, horizon=128, sqp_iters=8, pgd_iters=60,
        Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
        qf_scale=80.0, x_ref=np.zeros(2),
    )


@pytest.fixture(scope="module")
def swingup_solution(swingup):
    return swingup.solve(np.array([[0.5, 0.0]]))  # hanging, at rest


def test_swingup_is_underactuated(model):
    """The torque ceiling is below peak gravity torque: no single-pull
    solution exists, so reaching upright certifies energy pumping."""
    assert model.u_max < model.k_g


def test_swingup_reaches_upright(swingup, swingup_solution):
    words, costs = swingup_solution
    assert (np.diff(costs, axis=-1) < 1e-6).all(), costs
    plan = swingup.plan_phys(words)
    traj = swingup.model.reference_rollout(np.array([[0.5, 0.0]]), plan)
    th_f, om_f = traj[0, -1]
    assert abs(th_f) < 0.1 and abs(om_f) < 0.3, traj[0, -1]
    # the plan pumps: the torque reverses sign at least twice
    u = plan[0, :, 0]
    active = u[np.abs(u) > 0.05]
    sign_changes = int(np.sum(np.abs(np.diff(np.sign(active))) > 0))
    assert sign_changes >= 2, sign_changes


def test_swingup_on_quantized_plant(swingup, swingup_solution):
    """The packed int8 plan drives the fixed-point plant itself to upright,
    not just the float64 twin."""
    words, _ = swingup_solution
    model = swingup.model
    lanes = swingup.lanes(words)[:, : swingup.horizon]
    fp0 = jnp.asarray(model.to_fixed(np.array([[0.5, 0.0]])))
    states = model.rollout(fp0, jnp.asarray(lanes))
    final = model.to_float(np.asarray(states))[0, -1]
    assert abs(final[0]) < 0.11 and abs(final[1]) < 0.35, final


def test_swingup_matches_float64_reference(swingup, swingup_solution):
    _, costs = swingup_solution
    _, ref_costs = swingup.reference_solve(np.array([[0.5, 0.0]]))
    np.testing.assert_allclose(
        costs[:, -1], ref_costs[:, -1], rtol=0.02
    )


# -- closed loop: RTI regulation and plan-then-track swing-up -----------------


@pytest.fixture(scope="module")
def strong_model():
    # u_max 1.98 < k_g 2.5: still pump-required, but the upright basin
    # (|theta| ~ u_max / (16 k_g)) is wide enough to catch
    return Pendulum(u_shift=10)


def test_rti_regulation_short_horizon(strong_model):
    """Short-horizon RTI regulates near-upright starts to ~zero.  The
    horizon must be short: condensing an exponentially unstable plant
    conditions like e^(2*lambda*T), which defeats fixed-iteration PGD."""
    from pint_jax.mpc import SQPController

    m = strong_model
    sqp = QuantizedSQP(
        model=m, horizon=16, sqp_iters=1, pgd_iters=40,
        Q=np.diag([1.0, 0.05]), R=np.array([[0.02]]),
        qf_scale=40.0, x_ref=np.zeros(2), pad_to=16,
    )
    ctl = SQPController(sqp, iters_per_tick=1)
    states, _ = ctl.run(
        np.array([[0.05, 0.0], [-0.06, 0.1], [0.08, -0.2]]), ticks=96
    )
    thf = m.to_float(states)
    assert np.abs(thf[:, -30:, 0]).max() < 5e-3, thf[:, -5:, 0]
    assert np.abs(thf[:, -30:, 1]).max() < 2e-2


def test_plan_then_track_swingup(strong_model):
    """The full quantized pipeline: long-horizon SQP plans the swing-up
    offline; a short-horizon RTI tracker follows the planned state
    trajectory through the fixed-point plant and balances upright."""
    from pint_jax.mpc import SQPController

    m = strong_model
    planner = QuantizedSQP(
        model=m, horizon=128, sqp_iters=8, pgd_iters=60,
        Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
        qf_scale=80.0, x_ref=np.zeros(2),
    )
    x0 = np.array([[0.5, 0.0]])  # hanging, at rest
    plan_words, _ = planner.solve(x0)
    ref_traj = m.reference_rollout(x0[0], planner.plan_phys(plan_words)[0])
    ticks = 192
    xref = np.concatenate(
        [ref_traj, np.zeros((ticks + 16 - ref_traj.shape[0], 2))]
    )
    tracker = QuantizedSQP(
        model=m, horizon=16, sqp_iters=1, pgd_iters=40,
        Q=np.diag([1.0, 0.3]), R=np.array([[0.01]]),
        qf_scale=20.0, x_ref=np.zeros(2), pad_to=16,
    )
    ctl = SQPController(tracker, iters_per_tick=1)
    states, _ = ctl.run(x0, ticks=ticks, x_ref_traj=xref)
    thf = m.to_float(states)[0]
    assert np.abs(thf[-40:, 0]).max() < 0.01, thf[-5:]
    assert np.abs(thf[-40:, 1]).max() < 0.05


def test_tracking_ref_length_validated(strong_model):
    from pint_jax.mpc import SQPController

    sqp = QuantizedSQP(
        model=strong_model, horizon=16, Q=np.diag([1.0, 0.3]),
        R=np.array([[0.01]]), x_ref=np.zeros(2), pad_to=16,
    )
    ctl = SQPController(sqp)
    with pytest.raises(ValueError, match="x_ref_traj"):
        ctl.run(np.array([[0.1, 0.0]]), ticks=50, x_ref_traj=np.zeros((40, 2)))


def test_kg_overflow_bound_rejected():
    """k_g outside the int32 fixed-point budget raises instead of silently
    wrapping the gravity product (the f64 reference would not wrap, so the
    two would silently diverge)."""
    with pytest.raises(ValueError, match="k_g"):
        Pendulum(k_g=9.0)
    Pendulum(k_g=7.9)  # inside the bound: fine
