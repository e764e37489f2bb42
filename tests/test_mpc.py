"""Fixed-point MPC solver vs the float64 CPU reference.

Checks (per BASELINE.json): control sequences within quantization tolerance
of the float64 PGD reference under the same horizon / iteration budget, and
near-optimal cost.
"""

import jax
import numpy as np
import pytest

from pint_jax.mpc import FixedPointPGD, condense_double_integrator, quantize


@pytest.fixture(scope="module")
def qp():
    return condense_double_integrator(T=50)


@pytest.fixture(scope="module")
def qqp(qp):
    return quantize(qp)


def test_condensation_shapes(qp):
    assert qp.H.shape == (50, 50)
    assert qp.G.shape == (50, 2)
    # H is SPD
    eig = np.linalg.eigvalsh(qp.H)
    assert eig.min() > 0
    assert qp.lipschitz == pytest.approx(eig.max())


def test_quantization_fidelity(qp, qqp):
    alpha = 1.0 / qp.lipschitz
    back = qqp.Hq[:50, :50].astype(np.float64) * qqp.h_scale
    np.testing.assert_allclose(back, alpha * qp.H, atol=qqp.h_scale)
    # rational rescale approximates h_scale * 2^g_shift to <= 2^-9 relative
    val = qqp.h_scale * 2.0**qqp.g_shift
    assert abs(qqp.hs_num / 2.0**qqp.hs_den - val) / val < 2.0**-8


def test_reference_pgd_converges(qp):
    x0 = np.array([[2.0, 0.0], [-1.0, 0.5], [0.5, -1.0]])
    U20 = qp.solve_pgd(x0, iters=20)
    U200 = qp.solve_pgd(x0, iters=200)

    def cost(U):
        g = x0 @ qp.G.T + qp.g_ref
        return 0.5 * np.einsum("bi,ij,bj->b", U, qp.H, U) + np.einsum(
            "bi,bi->b", g, U
        )

    assert np.all(cost(U200) <= cost(U20) + 1e-9)
    assert np.all(np.abs(U200) <= qp.u_max + 1e-12)


def test_fixed_point_matches_reference(qp, qqp):
    solver = FixedPointPGD(qqp, iters=60)
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-3, 3, size=16), rng.uniform(-1, 1, size=16)], axis=-1
    )
    _, u_phys = solver.solve(x0)
    u_ref = qp.solve_pgd(x0, iters=60)

    got = np.asarray(u_phys)
    # Coordinate-wise tolerance is meaningful only in well-curved directions;
    # in the weakly-curved horizon tail (lambda_min ~ r = 0.01) both solvers
    # are ~half-converged after 60 iters and individual coordinates differ
    # while costs agree.  Quantization tolerance is therefore asserted as:
    #   (a) mean lane error a couple of int8 steps,
    #   (b) cost within a quantization-level margin of the reference.
    err_lanes = np.abs(got - u_ref) / qqp.u_scale
    assert err_lanes.mean() <= 2.0, f"mean lane error {err_lanes.mean()}"
    assert np.quantile(err_lanes, 0.9) <= 5.0

    c_got = solver.cost(got, x0)
    c_ref = solver.cost(u_ref, x0)
    c0 = solver.cost(np.zeros_like(got), x0)
    assert np.all(c_got - c_ref <= 0.02 * (c0 - c_ref + 1e-9))


def test_error_feedback_improves_accuracy(qp, qqp):
    rng = np.random.default_rng(5)
    x0 = np.stack(
        [rng.uniform(-3, 3, 24), rng.uniform(-1, 1, 24)], axis=-1
    )
    u_ref = qp.solve_pgd(x0, iters=60)
    errs, costs = {}, {}
    for ef in (False, True):
        s = FixedPointPGD(qqp, iters=60, error_feedback=ef)
        _, u = s.solve(x0)
        errs[ef] = (np.abs(np.asarray(u) - u_ref) / qqp.u_scale).mean()
        costs[ef] = (s.cost(np.asarray(u), x0) - s.cost(u_ref, x0)).max()
    assert errs[True] < errs[False]
    assert costs[True] <= costs[False] + 1e-9


def test_box_constraint_active_and_respected(qp, qqp):
    solver = FixedPointPGD(qqp, iters=80)
    # large initial position error drives controls to the box boundary
    x0 = np.array([[8.0, 0.0], [-8.0, 0.0]])
    _, u_phys = solver.solve(x0)
    got = np.asarray(u_phys)
    assert np.all(np.abs(got) <= qp.u_max + 1e-9)
    assert np.abs(got).max() >= qp.u_max - qqp.u_scale  # boundary reached


def test_solver_jits_once_and_batches(qqp):
    solver = FixedPointPGD(qqp, iters=10)
    g = np.zeros((32, qqp.padded), np.int32)
    u0 = solver.init_words(32)
    f = jax.jit(solver.solve_words)
    out = f(u0, jax.numpy.asarray(g))
    assert out.shape == (32, qqp.padded // 4)
    # zero linear term -> zero controls stay zero
    assert not np.asarray(out).any()


def test_condense_lti_multi_input():
    """2-D double integrator with 2 accel inputs (n=4, m=2)."""
    from pint_jax.mpc import condense_lti

    dt = 1 / 32
    A = np.block(
        [[np.eye(2), dt * np.eye(2)], [np.zeros((2, 2)), np.eye(2)]]
    )
    B = np.vstack([0.5 * dt * dt * np.eye(2), dt * np.eye(2)])
    Q = np.diag([1.0, 1.0, 0.1, 0.1])
    T = 30
    lti = condense_lti(A, B, Q, 0.01, 10 * Q, T, np.zeros(4), u_max=1.0)
    assert lti.H.shape == (60, 60)
    assert np.linalg.eigvalsh(lti.H).min() > 0

    # quantized solve vs float64 reference on the multi-input problem
    qqp = quantize(lti)
    assert qqp.padded == 64
    solver = FixedPointPGD(qqp, iters=60, error_feedback=True)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(-2, 2, size=(8, 4))
    _, u = solver.solve(x0)
    u_ref = lti.solve_pgd(x0, iters=60)
    c_got = solver.cost(np.asarray(u), x0)
    c_ref = solver.cost(u_ref, x0)
    c0 = solver.cost(np.zeros_like(u_ref), x0)
    assert np.all(c_got - c_ref <= 0.02 * (c0 - c_ref + 1e-9))
