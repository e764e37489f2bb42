"""Accelerated fixed-point PGD: convergence and fused bit-identity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.mpc import FixedPointPGD, condense_double_integrator, quantize
from pint_jax.mpc.accelerated import AcceleratedPGD
from pint_jax.mpc.fused import FusedPGD


@pytest.fixture(scope="module")
def qp():
    return condense_double_integrator(T=50)


@pytest.fixture(scope="module")
def qqp(qp):
    return quantize(qp)


def _x0(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(-3, 3, n), rng.uniform(-1, 1, n)], axis=-1
    )


def test_acceleration_beats_plain_pgd(qp, qqp):
    """At 20 iterations the accelerated solver must reach at least the cost
    plain PGD needs ~60 iterations for (sqrt(kappa) speedup)."""
    x0 = _x0(32)
    u_star = qp.solve_pgd(x0, iters=2000)
    helper = FixedPointPGD(qqp, iters=1)

    def excess(u):
        return (helper.cost(np.asarray(u), x0) - helper.cost(u_star, x0)).max()

    _, u_acc20 = AcceleratedPGD(qqp, iters=20).solve(x0)
    _, u_pgd60 = FixedPointPGD(qqp, iters=60).solve(x0)
    assert excess(u_acc20) <= excess(u_pgd60) * 1.2


def test_accelerated_stays_in_box(qqp):
    solver = AcceleratedPGD(qqp, iters=50)
    x0 = np.array([[8.0, 0.0], [-8.0, 0.0]])
    _, u = solver.solve(x0)
    assert np.abs(np.asarray(u)).max() <= qqp.qp.u_max + 1e-9


def test_fused_momentum_matches_accelerated(qqp):
    iters = 15
    batch = 64
    x0 = _x0(batch, seed=2)
    g = jnp.asarray(qqp.g_lane_fixed(x0))
    acc = AcceleratedPGD(qqp, iters=iters)
    fused = FusedPGD(
        qqp, iters=iters, momentum=True, block_rows=64, interpret=True
    )
    w1 = jax.jit(acc.solve_words)(acc.init_words(batch), g)
    w2 = fused.solve_words(fused.init_words(batch), g)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))
