"""PlanarQuadrotor (n=6, m=2) through the DEVICE solver tiers.

The third model family for DeviceSQP / DeviceConstrainedSQP (the host
LTI hover loop lives in test_quadrotor.py): exercises the pivot-free
Gauss-Jordan inverse at its largest claimed lane count n=6
(DeviceSQP._inv_unrolled via the allpairs propagator), multi-input
packing at m=2 over a 6-state condensation, and the constrained tier on
a genuinely bigger state than unicycle/pendulum.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models.quadrotor import PlanarQuadrotor
from pint_jax.mpc import DeviceSQP, QuantizedSQP

KW = dict(
    model=PlanarQuadrotor(), horizon=16, sqp_iters=4, pgd_iters=30,
    Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
    R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6),
)


@pytest.fixture(scope="module")
def pair():
    return QuantizedSQP(**KW), DeviceSQP(**KW)


@pytest.fixture(scope="module")
def x0():
    # offsets from hover: position, small tilt, small velocities
    return np.array(
        [
            [0.3, -0.2, 0.01, 0.0, 0.0, 0.0],
            [-0.2, 0.1, -0.02, 0.1, -0.1, 0.02],
            [0.0, 0.3, 0.03, -0.1, 0.0, -0.03],
        ]
    )


def test_device_matches_host_path(pair, x0):
    """f32 on-device condensation at n=6 tracks the f64 host path to a
    fraction of a percent in final true cost (the pendulum/unicycle
    contract, now at the 6-state multi-input family)."""
    host, dev = pair
    _, host_costs = host.solve(x0)
    words, _ = dev.solve(x0)
    dev_costs = host.true_cost(x0, host.lanes(words))
    np.testing.assert_allclose(
        dev_costs, host_costs[:, -1], rtol=0.01, atol=1e-4
    )


def test_device_regulates_to_hover(pair, x0):
    """The device plan strictly improves on the zero (pure-hover) plan."""
    host, dev = pair
    words, _ = dev.solve(x0)
    cost = host.true_cost(x0, host.lanes(words))
    zero = host.true_cost(x0, np.zeros((x0.shape[0], dev.n_dec)))
    # authority is modest (+-0.99 N/rotor vs 9.8 N gravity over a 0.5 s
    # horizon), so the margin is single-digit-to-tens of percent
    assert (cost < 0.92 * zero).all(), (cost, zero)


def test_device_deterministic(pair, x0):
    _, dev = pair
    w1, _ = dev.solve(x0)
    w2, _ = dev.solve(x0)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))


def test_allpairs_agrees_at_n6(x0):
    """allpairs condensation (prefix products + Gauss-Jordan inverses,
    _inv_unrolled at n=6) agrees with the scan path to f32 roundoff, and
    the end-to-end solves land within one int8 lane step."""
    kw = dict(KW, sqp_iters=2, pgd_iters=10)
    d_ap = DeviceSQP(**kw, propagate="allpairs")
    d_sc = DeviceSQP(**kw, propagate="scan")
    rng = np.random.default_rng(3)
    B = 4
    x = jnp.asarray(rng.normal(size=(B, 6)) * 0.2, jnp.float32)
    lanes = jnp.asarray(
        rng.integers(-40, 40, size=(B, d_ap.n_dec)), jnp.int32
    )
    for a, b in zip(d_ap._condense_hg(x, lanes),
                    d_sc._condense_hg(x, lanes)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * (np.abs(b).max() + 1e-12)
    from pint_jax.models.dynamics import unpack_controls

    w_ap = d_ap.solve_words(d_ap.init_words(B), x)
    w_sc = d_sc.solve_words(d_sc.init_words(B), x)
    l_ap = (np.asarray(unpack_controls(w_ap), np.int64) + 128) % 256 - 128
    l_sc = (np.asarray(unpack_controls(w_sc), np.int64) + 128) % 256 - 128
    assert np.abs(l_ap - l_sc).max() <= 1


def test_device_constrained_corridor(x0):
    """DeviceConstrainedSQP on the 6-state model: a vertical-velocity
    corridor (directly actuated by total thrust) that genuinely binds is
    held on the true nonlinear rollout, deterministically."""
    from pint_jax.mpc import DeviceConstrainedSQP

    dev = DeviceSQP(**KW)
    # |vy| corridor tighter than the unconstrained plan's swing
    F = [[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]]
    devc = DeviceConstrainedSQP(dev, F=F, lo=-0.15, hi=0.15,
                                rho=50.0, alm_outer=3)
    B = x0.shape[0]
    w_u = dev.solve_words(dev.init_words(B), np.asarray(x0, np.float32))
    from pint_jax.models.dynamics import unpack_controls

    def lanes_of(w):
        l = (np.asarray(unpack_controls(w), np.int64) + 128) % 256 - 128
        return l[:, : dev.n_dec].astype(np.float64)

    # the corridor genuinely binds: the unconstrained plan violates it
    swing_u = devc.violation(np.asarray(x0, np.float32), lanes_of(w_u))
    assert swing_u.max() > 0.02, swing_u

    w_c, lam = devc.solve_words(devc.init_words(B),
                                np.asarray(x0, np.float32))
    viol = devc.violation(np.asarray(x0, np.float32), lanes_of(w_c))
    assert viol.max() < 0.01, viol
    assert int(np.abs(np.asarray(lam)).max()) > 0

    w2, l2 = devc.solve_words(devc.init_words(B),
                              np.asarray(x0, np.float32))
    np.testing.assert_array_equal(np.asarray(w_c), np.asarray(w2))
    np.testing.assert_array_equal(np.asarray(lam), np.asarray(l2))


@pytest.mark.parametrize("dp,tp", [(8, 1), (2, 4)])
def test_sharded_bit_identical(pair, dp, tp):
    """dp x tp sharded solve reproduces the single-device solve word for
    word at n=6, m=2 (the packing/condensation shapes differ from every
    other family: Tm = 32 lanes over 8 words/problem)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pint_jax.parallel import make_mesh

    _, dev = pair
    B = 8
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, 6)).astype(np.float32) * 0.2
    u0 = dev.init_words(B)
    w_single = dev.solve_words(u0, x)

    mesh = make_mesh(dp=dp, tp=tp)
    solve = dev.sharded_solve_words(mesh)
    xj = jnp.asarray(x)
    import jax

    xj = jax.device_put(xj, NamedSharding(mesh, P("dp", None)))
    uj = jax.device_put(u0, NamedSharding(mesh, P("dp", "tp")))
    w_sh = solve(uj, xj)
    assert jnp.array_equal(w_single, w_sh)
