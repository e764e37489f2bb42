"""State-constrained nonlinear SQP: corridor-bounded unicycle planning.

Oracle chain: the unconstrained QuantizedSQP establishes that the limit is
binding; the float64 reference_solve (same SQP+ALM structure, no
quantization) bounds what any solver at this budget achieves; the quantized
device path must match its violation band and cost within tolerance.
Feasibility is always checked on the TRUE nonlinear rollout, not the
linearization."""

import numpy as np
import pytest

from pint_jax.mpc.ltv import QuantizedSQP
from pint_jax.mpc.sqp_constrained import ConstrainedSQP

X0 = np.array([[0.0, 0.0, np.pi / 2], [0.0, 0.0, -np.pi / 2]])


@pytest.fixture(scope="module")
def sqp():
    return QuantizedSQP(
        horizon=32, sqp_iters=6, pgd_iters=40,
        x_ref=np.array([1.0, 0.0, 0.0]),
    )


@pytest.fixture(scope="module")
def unconstrained_lanes(sqp):
    w, _ = sqp.solve(X0)
    return sqp.lanes(w)


def test_inactive_constraint_is_inert(sqp, unconstrained_lanes):
    """A corridor wider than the unconstrained swing changes nothing:
    same cost to within quantization noise, zero multipliers."""
    csqp = ConstrainedSQP(
        sqp, F=[[0.0, 1.0, 0.0]], lo=-0.5, hi=0.5, rho=50.0, alm_outer=2
    )
    w, lam, costs = csqp.solve(X0)
    assert csqp.violation(X0, sqp.lanes(w)).max() == 0.0
    assert int(np.abs(np.asarray(lam)).max()) == 0
    cost_unc = sqp.true_cost(X0, unconstrained_lanes)
    assert np.abs(costs[:, -1] - cost_unc).max() < 0.02 * np.abs(cost_unc).max()


def test_binding_corridor(sqp, unconstrained_lanes):
    bound = 0.03
    csqp = ConstrainedSQP(
        sqp, F=[[0.0, 1.0, 0.0]], lo=-bound, hi=bound, rho=100.0,
        alm_outer=4,
    )
    # the limit is genuinely binding for the unconstrained plan
    unc_swing = np.abs(
        csqp.constraint_trajectory(X0, unconstrained_lanes)
    ).max()
    assert unc_swing > 2 * bound

    w, lam, costs = csqp.solve(X0)
    lanes = sqp.lanes(w)
    viol = csqp.violation(X0, lanes)
    U_ref, _ = csqp.reference_solve(X0)
    viol_ref = csqp.violation(X0, np.round(U_ref))
    # device feasibility within the reference's own band (+1 lane slack)
    assert viol.max() < viol_ref.max() + 3e-3, (viol, viol_ref)
    assert viol.max() < bound / 3  # and absolutely small vs the 2x overshoot
    cost_ref = sqp.true_cost(X0, U_ref)
    assert np.abs(costs[:, -1] - cost_ref).max() < 0.01 * np.abs(cost_ref).max()
    assert int(np.abs(np.asarray(lam)).max()) > 0


def test_deterministic(sqp):
    csqp = ConstrainedSQP(
        sqp, F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=2
    )
    w1, l1, _ = csqp.solve(X0, track_costs=False)
    w2, l2, _ = csqp.solve(X0, track_costs=False)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_validation(sqp):
    bad_F = ConstrainedSQP(sqp, F=[[0.0, 1.0]], lo=-1, hi=1)
    with pytest.raises(ValueError):
        bad_F.solve(X0, track_costs=False)
    with pytest.raises(ValueError):
        ConstrainedSQP(sqp, F=[[0.0, 1.0, 0.0]], lo=1.0, hi=-1.0).solve(
            X0, track_costs=False
        )
