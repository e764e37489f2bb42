"""State-constrained MPC: stacked constraint rows + ALM reference solver.

The oracle chain: explicit state rollout (independent simulation) validates
the stacked S/P/r rows; scipy SLSQP validates the float64 ALM solver; the
float64 ALM solver then serves as the reference for the quantized device
solver (test_constrained_device.py)."""

import numpy as np
import pytest

from pint_jax.mpc.condensed import condense_double_integrator, condense_lti
from pint_jax.mpc.constrained import StateConstrainedQP, constrain_states

T, DT = 50, 1.0 / 32.0
A_DI = np.array([[1.0, DT], [0.0, 1.0]])
B_DI = np.array([[0.5 * DT * DT], [DT]])


def _di_problem(v_max=0.25, q_pos=4.0):
    qp = condense_double_integrator(T=T, dt=DT, q_pos=q_pos)
    sc = constrain_states(
        qp,
        np.broadcast_to(A_DI, (T, 2, 2)),
        np.broadcast_to(B_DI, (T, 2, 1)),
        None,
        F=[[0.0, 1.0]],
        lo=-v_max,
        hi=v_max,
    )
    return qp, sc


def _rollout(A_seq, B_seq, c_seq, x0, U, m):
    """Independent explicit simulation; returns states x_1..x_T."""
    x = np.asarray(x0, float)
    out = []
    for k in range(A_seq.shape[0]):
        u = U[k * m : (k + 1) * m]
        x = A_seq[k] @ x + B_seq[k] @ u + c_seq[k]
        out.append(x)
    return np.stack(out)


def test_constraint_rows_match_rollout_lti():
    qp, sc = _di_problem()
    rng = np.random.default_rng(0)
    U = rng.uniform(-1, 1, size=T)
    x0 = rng.uniform(-1, 1, size=2)
    xs = _rollout(
        np.broadcast_to(A_DI, (T, 2, 2)),
        np.broadcast_to(B_DI, (T, 2, 1)),
        np.zeros((T, 2)),
        x0,
        U,
        1,
    )
    c = sc.constraint(U[None], x0[None])[0]
    np.testing.assert_allclose(c, xs[:, 1], rtol=1e-12, atol=1e-12)


def test_constraint_rows_match_rollout_ltv_affine():
    """Time-varying A/B with affine offsets: rows still equal the explicit
    rollout (the SQP linearization path)."""
    rng = np.random.default_rng(1)
    n, m, Tl = 3, 2, 12
    A_seq = np.eye(n) + 0.05 * rng.standard_normal((Tl, n, n))
    B_seq = 0.3 * rng.standard_normal((Tl, n, m))
    c_seq = 0.1 * rng.standard_normal((Tl, n))
    F = rng.standard_normal((2, n))
    qp = condense_lti(
        np.eye(n), np.ones((n, m)), np.eye(n), 0.1, np.eye(n), Tl,
        np.zeros(n), 1.0,
    )  # objective irrelevant for this test; only the rows are checked
    sc = constrain_states(qp, A_seq, B_seq, c_seq, F, -1.0, 1.0)
    U = rng.uniform(-1, 1, size=Tl * m)
    x0 = rng.uniform(-1, 1, size=n)
    xs = _rollout(A_seq, B_seq, c_seq, x0, U, m)
    c = sc.constraint(U[None], x0[None])[0]
    np.testing.assert_allclose(
        c, (xs @ F.T).reshape(-1), rtol=1e-10, atol=1e-12
    )


def test_alm_matches_scipy():
    scipy_opt = pytest.importorskip("scipy.optimize")
    qp, sc = _di_problem()
    x0 = np.array([[-1.0, 0.0], [0.8, -0.1]])
    U, lam = sc.solve_alm(x0, rho=100.0, outer=40, inners=300)
    c = sc.constraint(U, x0)
    viol = np.maximum(c - sc.hi, 0).max() + np.maximum(sc.lo - c, 0).max()
    assert viol < 1e-3
    assert sc.kkt_residual(U, lam, x0).max() < 5e-3
    for b in range(2):
        g0 = x0[b] @ qp.G.T + qp.g_ref
        res = scipy_opt.minimize(
            lambda u: 0.5 * u @ qp.H @ u + g0 @ u,
            np.zeros(T),
            jac=lambda u: qp.H @ u + g0,
            method="SLSQP",
            bounds=[(-qp.u_max, qp.u_max)] * T,
            constraints=[
                scipy_opt.LinearConstraint(
                    sc.S,
                    sc.lo - sc.P @ x0[b] - sc.r,
                    sc.hi - sc.P @ x0[b] - sc.r,
                )
            ],
            options=dict(maxiter=500, ftol=1e-12),
        )
        cost = 0.5 * U[b] @ qp.H @ U[b] + g0 @ U[b]
        assert abs(cost - res.fun) / abs(res.fun) < 2e-3


def test_alm_activates_only_when_needed():
    qp, sc = _di_problem()
    # far start: the unconstrained plan violates the velocity limit
    x0_hot = np.array([[-1.0, 0.0]])
    U_unc = qp.solve_pgd(x0_hot, iters=400)
    assert np.abs(sc.constraint(U_unc, x0_hot)).max() > 0.5
    U, lam = sc.solve_alm(x0_hot, rho=50.0, outer=25, inners=200)
    assert np.abs(sc.constraint(U, x0_hot)).max() < 0.25 + 5e-3
    assert np.abs(lam).max() > 0  # multipliers engaged
    # near start: limit inactive, ALM returns the unconstrained optimum
    # (costs compared, not iterates: the ALM inner step 1/(L_H + rho*L_S)
    # is much smaller than the plain-PGD step, so flat-direction iterate
    # convergence differs at finite iteration counts)
    x0_cold = np.array([[-0.02, 0.0]])
    U2, lam2 = sc.solve_alm(x0_cold, rho=1.0, outer=3, inners=500)
    U2_ref = qp.solve_pgd(x0_cold, iters=1500)
    g0 = x0_cold[0] @ qp.G.T + qp.g_ref
    cost = lambda u: 0.5 * u @ qp.H @ u + g0 @ u
    assert abs(cost(U2[0]) - cost(U2_ref[0])) < 1e-6
    assert np.abs(sc.constraint(U2, x0_cold)).max() < 0.25
    assert np.abs(lam2).max() < 1e-9


def test_constrain_states_validation():
    qp, _ = _di_problem()
    A_seq = np.broadcast_to(A_DI, (T, 2, 2))
    B_seq = np.broadcast_to(B_DI, (T, 2, 1))
    with pytest.raises(ValueError):
        constrain_states(qp, A_seq[:10], B_seq, None, [[0.0, 1.0]], -1, 1)
    with pytest.raises(ValueError):
        constrain_states(qp, A_seq, B_seq, None, [[0.0, 1.0, 2.0]], -1, 1)
    with pytest.raises(ValueError):
        constrain_states(qp, A_seq, B_seq, None, [[0.0, 1.0]], 1.0, -1.0)


# ---------------------------------------------------------------------------
# Quantized device tier
# ---------------------------------------------------------------------------

import jax
import jax.numpy as jnp

from pint_jax.mpc.constrained import ConstrainedPGD, quantize_constrained

RHO = 50.0


def _device_setup(outer=12, inners=60):
    qp, sc = _di_problem()
    qc = quantize_constrained(sc, rho=RHO)
    return qp, sc, ConstrainedPGD(qc, outer=outer, inners=inners)


X0 = np.array([[-1.0, 0.0], [0.8, -0.1], [0.0, 0.2], [0.3, 0.24]])


def test_device_matches_float64_alm():
    """The int8/int32 device ALM tracks the float64 reference at the same
    (rho, outer, inners): cost gap under 0.5%, feasibility within the same
    band the reference itself achieves at this budget."""
    qp, sc, solver = _device_setup()
    _, U, lam = solver.solve(X0)
    U = np.asarray(U, np.float64)
    U_ref, _ = sc.solve_alm(X0, rho=RHO, outer=12, inners=60)
    g0 = X0 @ qp.G.T + qp.g_ref
    cost = lambda u: 0.5 * np.einsum("bi,ij,bj->b", u, qp.H, u) + np.einsum(
        "bi,bi->b", g0, u
    )
    gap = np.abs(cost(U) - cost(U_ref)) / np.abs(cost(U_ref))
    assert gap.max() < 5e-3, gap
    c = sc.constraint(U, X0)
    viol = np.maximum(c - sc.hi, 0).max() + np.maximum(sc.lo - c, 0).max()
    c_ref = sc.constraint(U_ref, X0)
    viol_ref = np.maximum(c_ref - sc.hi, 0).max() + np.maximum(
        sc.lo - c_ref, 0
    ).max()
    assert viol < viol_ref + 5e-3, (viol, viol_ref)


def test_device_constraint_engages():
    """Constrained device plan respects the velocity limit the unconstrained
    device solver blows through."""
    from pint_jax.mpc import FixedPointPGD, quantize

    qp, sc, solver = _device_setup()
    x0 = np.array([[-1.0, 0.0]])
    unc = FixedPointPGD(quantize(qp), iters=200)
    _, U_unc = unc.solve(x0)
    assert np.abs(sc.constraint(np.asarray(U_unc, np.float64), x0)).max() > 0.5
    _, U, lam = solver.solve(x0)
    c = sc.constraint(np.asarray(U, np.float64), x0)
    assert np.abs(c).max() < 0.25 + 1e-2
    assert int(jnp.abs(lam).max()) > 0


def test_device_deterministic():
    _, _, solver = _device_setup(outer=4, inners=20)
    w1, _, l1 = solver.solve(X0)
    w2, _, l2 = solver.solve(X0)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_device_dp_sharded_bit_identical(dp):
    """Pure-integer solver: shard_map over a dp mesh reproduces the
    single-device packed words exactly on every mesh shape."""
    from jax.sharding import Mesh, PartitionSpec as P

    _, _, solver = _device_setup(outer=6, inners=25)
    x0 = np.concatenate([X0, -X0], axis=0)  # batch 8
    g = jnp.asarray(solver._q.g_lane_fixed(x0))
    co = jnp.asarray(solver.qcqp.c_off_pre(x0))
    u0 = solver.init_words(x0.shape[0])

    w1, l1 = jax.jit(solver.solve_words)(u0, g, co)

    mesh = Mesh(np.array(jax.devices()[:dp]), ("dp",))
    fn = jax.shard_map(
        solver.solve_words,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp")),
    )
    w2, l2 = jax.jit(fn)(u0, g, co)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_quantize_constrained_validation():
    qp, sc = _di_problem()
    zero_sc = dataclasses_replace_S(sc)
    with pytest.raises(ValueError):
        quantize_constrained(zero_sc, rho=RHO)


def dataclasses_replace_S(sc):
    import dataclasses as _dc

    return _dc.replace(sc, S=np.zeros_like(sc.S))


def test_constrained_closed_loop():
    """Receding-horizon loop with warm-started multipliers: the closed-loop
    trajectory respects the velocity limit the unconstrained controller
    blows through ~6x, and still regulates to the origin."""
    from pint_jax.models.dynamics import DoubleIntegrator
    from pint_jax.mpc import ConstrainedController, RecedingHorizonController

    model = DoubleIntegrator()
    Th, dt = 32, model.dt
    u_max = 127 * model.u_scale
    v_max = 0.15
    qp = condense_double_integrator(T=Th, dt=dt, q_pos=4.0, u_max=u_max)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(
        qp,
        np.broadcast_to(A, (Th, 2, 2)),
        np.broadcast_to(Bm, (Th, 2, 1)),
        None,
        F=[[0.0, 1.0]],
        lo=-v_max,
        hi=v_max,
    )
    ctrl = ConstrainedController(
        quantize_constrained(sc, rho=RHO),
        plant_step=lambda s, u: model.step(s, u[..., 0]),
        frac_bits=model.frac_bits,
        outer_per_tick=3,
        inners_per_outer=15,
    )
    x0 = jnp.asarray(
        np.array([[-1.5 * 2**16, 0.0], [1.0 * 2**16, 0.0]]), jnp.int32
    )
    states, _ = jax.jit(lambda s: ctrl.run(s, 400))(x0)
    v = np.asarray(states)[..., 1] * 2.0**-16
    p = np.asarray(states)[..., 0] * 2.0**-16
    assert np.abs(v).max() < v_max + 0.01        # hard limit held (~2% tol)
    assert np.abs(p[:, -1]).max() < 0.01         # still regulates

    unc = RecedingHorizonController.build(
        model, horizon=Th, iters_per_tick=45, q_pos=4.0
    )
    s2, _ = jax.jit(lambda s: unc.run(s, 400))(x0)
    v2 = np.asarray(s2)[..., 1] * 2.0**-16
    assert np.abs(v2).max() > 4 * v_max          # the limit was binding
