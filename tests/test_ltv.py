"""LTV condensation and the quantized SQP trajectory optimizer."""

import numpy as np
import pytest

from pint_jax.models.dynamics import Unicycle
from pint_jax.mpc import QuantizedSQP, condense_lti, condense_ltv


def test_condense_ltv_matches_lti():
    """Constant A, B, c=0 must reduce exactly to the LTI condensation."""
    rng = np.random.default_rng(0)
    n, m, T = 3, 2, 12
    A = np.eye(n) + 0.05 * rng.standard_normal((n, n))
    B = 0.3 * rng.standard_normal((n, m))
    Q = np.diag([1.0, 2.0, 0.5])
    R = np.diag([0.1, 0.2])
    Qf = 5.0 * Q
    x_ref = np.array([1.0, -0.5, 0.25])
    lti = condense_lti(A, B, Q, R, Qf, T, x_ref, u_max=2.0)
    ltv = condense_ltv(
        np.broadcast_to(A, (T, n, n)),
        np.broadcast_to(B, (T, n, m)),
        None,
        Q, R, Qf, x_ref, u_max=2.0,
    )
    np.testing.assert_allclose(ltv.H, lti.H, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ltv.G, lti.G, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ltv.g_ref, lti.g_ref, rtol=1e-10, atol=1e-12)


def test_condense_ltv_drift_and_timevarying_ref():
    """The affine drift and per-step references enter g exactly: the
    unconstrained minimizer of the condensed QP reproduces the minimizer of
    the explicit rollout objective."""
    rng = np.random.default_rng(1)
    n, m, T = 2, 1, 6
    A_seq = np.stack([np.eye(n) + 0.1 * rng.standard_normal((n, n)) for _ in range(T)])
    B_seq = 0.5 * rng.standard_normal((T, n, m))
    c_seq = 0.2 * rng.standard_normal((T, n))
    Q = np.eye(n)
    R = 0.5
    x_ref = rng.standard_normal((T, n))
    qp = condense_ltv(A_seq, B_seq, c_seq, Q, R, 1.0 * Q, x_ref, u_max=1e9)
    x0 = rng.standard_normal(n)

    # analytic minimizer of 1/2 U^T H U + g^T U
    g = qp.G @ x0 + qp.g_ref
    U_star = np.linalg.solve(qp.H, -g)

    # numerical check: gradient of the explicit objective at U_star is ~0
    def full_obj(U):
        x = x0.copy()
        total = 0.0
        for k in range(T):
            x = A_seq[k] @ x + B_seq[k] @ U[k : k + 1] + c_seq[k]
            total += (x - x_ref[k]) @ Q @ (x - x_ref[k])
        return total + R * (U @ U)

    eps = 1e-6
    grad = np.array([
        (full_obj(U_star + eps * e) - full_obj(U_star - eps * e)) / (2 * eps)
        for e in np.eye(T)
    ])
    assert np.abs(grad).max() < 1e-5


def test_unicycle_linearize_vs_finite_differences():
    model = Unicycle()
    rng = np.random.default_rng(2)
    states = rng.uniform(-1, 1, (20, 3))
    controls = rng.uniform(-0.3, 0.3, (20, 2))
    A, B = model.linearize(states, controls)

    def step(x, u):
        return model.reference_rollout(x, u[None, :])[1]

    eps = 1e-7
    for i in range(20):
        for j in range(3):
            e = np.zeros(3)
            e[j] = eps
            # avoid differencing across the piecewise-trig kinks
            col = (
                step(states[i] + e, controls[i])
                - step(states[i] - e, controls[i])
            ) / (2 * eps)
            np.testing.assert_allclose(A[i, :, j], col, atol=1e-5)
        for j in range(2):
            e = np.zeros(2)
            e[j] = eps
            col = (
                step(states[i], controls[i] + e)
                - step(states[i], controls[i] - e)
            ) / (2 * eps)
            np.testing.assert_allclose(B[i, :, j], col, atol=1e-5)


@pytest.fixture(scope="module")
def sqp():
    return QuantizedSQP(
        horizon=32, sqp_iters=6, pgd_iters=40,
        Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
        qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
    )


@pytest.fixture(scope="module")
def sqp_x0():
    # third problem starts facing 0.9 turns: progress rides on heading
    # changes whose gradient components are sub-lane (the error-feedback
    # regression case)
    return np.array(
        [[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1], [0.05, -0.1, 0.9]]
    )


@pytest.fixture(scope="module")
def sqp_solution(sqp, sqp_x0):
    return sqp.solve(sqp_x0)


def test_sqp_cost_decreases(sqp, sqp_x0, sqp_solution):
    _, costs = sqp_solution
    # every SQP pass improves (or holds) the true nonlinear objective
    assert (np.diff(costs, axis=-1) < 1e-6).all(), costs
    assert (costs[:, -1] < 0.65 * costs[:, 0]).all(), costs


def test_sqp_reaches_goal(sqp, sqp_x0, sqp_solution):
    words, _ = sqp_solution
    plans = sqp.plan_phys(words)
    traj = sqp.model.reference_rollout(sqp_x0, plans)
    final = traj[:, -1, :2]
    dist = np.linalg.norm(final - np.array([0.2, 0.1]), axis=-1)
    # problem 3 is heading-limited within the horizon (the float64 oracle
    # lands at the same distance); the bound reflects that
    assert (dist < np.array([0.08, 0.08, 0.2])).all(), dist


def test_sqp_matches_float64_reference(sqp, sqp_x0, sqp_solution):
    """Quantized SQP tracks the float64 SQP oracle to sub-percent final
    cost (identical algorithm, iteration counts and step rule; the only
    difference is int8/int32 fixed-point arithmetic)."""
    words, costs = sqp_solution
    _, ref_costs = sqp.reference_solve(sqp_x0)
    np.testing.assert_allclose(
        costs[:, -1], ref_costs[:, -1], rtol=0.02, atol=1e-4
    )


def test_sqp_batch_determinism(sqp, sqp_x0, sqp_solution):
    """Each problem's result is independent of its batch companions."""
    words_batch, _ = sqp_solution
    solo, _ = sqp.solve(sqp_x0[1:2])
    np.testing.assert_array_equal(
        np.asarray(words_batch)[1], np.asarray(solo)[0]
    )


def test_sqp_controller_unicycle_closed_loop(sqp):
    """Receding-horizon RTI on the unicycle: one warm-started SQP
    iteration per tick reaches the goal through the quantized plant."""
    from pint_jax.mpc import SQPController

    ctl = SQPController(sqp, iters_per_tick=1)
    x0 = np.array([[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1]])
    states, applied = ctl.run(x0, ticks=48)
    assert states.shape == (2, 49, 3) and applied.shape == (2, 48, 2)
    xyf = sqp.model.to_float(states)[:, -1, :2]
    dist = np.linalg.norm(xyf - np.array([0.2, 0.1]), axis=-1)
    assert (dist < 0.06).all(), dist


def test_condense_ltv_batch_matches_scalar():
    """The batched condensation reproduces per-problem condense_ltv."""
    from pint_jax.mpc.condensed import condense_ltv_batch

    rng = np.random.default_rng(5)
    B, T, n, m = 4, 10, 3, 2
    A_seq = np.eye(n) + 0.1 * rng.standard_normal((B, T, n, n))
    B_seq = 0.4 * rng.standard_normal((B, T, n, m))
    c_seq = 0.1 * rng.standard_normal((B, T, n))
    Q = np.diag([1.0, 0.5, 0.2])
    R = np.diag([0.1, 0.3])
    Qf = 7.0 * Q
    x_ref = rng.standard_normal((T, n))
    H, G, g_ref, lip = condense_ltv_batch(A_seq, B_seq, c_seq, Q, R, Qf, x_ref)
    for b in range(B):
        qp = condense_ltv(
            A_seq[b], B_seq[b], c_seq[b], Q, R, Qf, x_ref, u_max=1.0
        )
        np.testing.assert_allclose(H[b], qp.H, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(G[b], qp.G, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(g_ref[b], qp.g_ref, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(lip[b], qp.lipschitz, rtol=1e-10)


def test_dare_terminal_fixed_point_and_short_horizon():
    """dare_terminal solves the DARE (fixed-point residual ~0) and, used as
    the terminal weight, lets a T=8 regulator match what the qf heuristic
    needs T=32 for (the short-horizon enabler for unstable plants)."""
    from pint_jax.models import Pendulum
    from pint_jax.mpc import SQPController, dare_terminal

    m = Pendulum(u_shift=10)
    A, B = m.linearize(np.zeros(2), np.zeros(1))
    s = m.lane_scales
    Q = np.diag([1.0, 0.05])
    R_lane = s[:, None] * np.array([[0.02]]) * s[None, :]
    P = dare_terminal(A, B * s, Q, R_lane)
    # Riccati residual
    BtP = (B * s).T @ P
    K = np.linalg.solve(R_lane + BtP @ (B * s), BtP @ A)
    resid = Q + A.T @ P @ (A - (B * s) @ K) - P
    assert np.abs(resid).max() < 1e-8

    sqp = QuantizedSQP(
        model=m, horizon=8, sqp_iters=1, pgd_iters=40,
        Q=Q, R=np.array([[0.02]]), Qf=P, x_ref=np.zeros(2), pad_to=8,
    )
    ctl = SQPController(sqp, iters_per_tick=1)
    states, _ = ctl.run(np.array([[0.06, 0.0], [-0.07, 0.15]]), ticks=96)
    thf = m.to_float(states)
    # heuristic qf_scale=40 at T=8 plateaus ~2.3e-3; DARE reaches ~1e-4
    assert np.abs(thf[:, -30:, 0]).max() < 5e-4
