"""Multi-device sharding tests on the virtual 8-CPU mesh.

The sharded solver must be *bit-identical* to the single-device solver for
every mesh shape: int32 psum is exact and associative, so distribution must
not change a single lane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models.dynamics import unpack_controls
from pint_jax.mpc import FixedPointPGD, condense_double_integrator, quantize
from pint_jax.parallel import ShardedPGD, make_mesh


@pytest.fixture(scope="module")
def qqp():
    return quantize(condense_double_integrator(T=50))


def _x0_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(-3, 3, size=n), rng.uniform(-1, 1, size=n)], axis=-1
    )


def test_eight_devices_available():
    assert jax.device_count() >= 8


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_single_device(qqp, dp, tp):
    iters = 25
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    sharded = ShardedPGD(qqp, mesh, iters=iters)
    single = FixedPointPGD(qqp, iters=iters)

    x0 = _x0_batch(16)
    words_s, u_s, residual = sharded.solve(x0)
    words_1, u_1 = single.solve(x0)

    np.testing.assert_array_equal(np.asarray(words_s), np.asarray(words_1))
    np.testing.assert_array_equal(np.asarray(u_s), np.asarray(u_1))
    assert np.isfinite(float(residual))


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4)])
def test_sharded_momentum_matches_accelerated(qqp, dp, tp):
    from pint_jax.mpc.accelerated import AcceleratedPGD

    iters = 15
    mesh = make_mesh(dp=dp, tp=tp)
    sharded = ShardedPGD(qqp, mesh, iters=iters, momentum=True)
    acc = AcceleratedPGD(qqp, iters=iters)
    x0 = _x0_batch(16, seed=9)
    words_s, _, _ = sharded.solve(x0)
    g = jax.numpy.asarray(qqp.g_lane_fixed(x0))
    words_a = jax.jit(acc.solve_words)(acc.init_words(16), g)
    np.testing.assert_array_equal(np.asarray(words_s), np.asarray(words_a))


def test_sharded_solution_quality(qqp):
    mesh = make_mesh(dp=2, tp=4)
    sharded = ShardedPGD(qqp, mesh, iters=60)
    x0 = _x0_batch(8, seed=3)
    _, u_phys, _ = sharded.solve(x0)
    u_ref = qqp.qp.solve_pgd(x0, iters=60)
    err_lanes = np.abs(np.asarray(u_phys) - u_ref) / qqp.u_scale
    assert err_lanes.mean() <= 3.0
    # the authoritative tolerance is cost excess (weak-direction lane noise
    # is cost-free; see test_mpc.py)
    single = FixedPointPGD(qqp, iters=60)
    c_got = single.cost(np.asarray(u_phys), x0)
    c_ref = single.cost(u_ref, x0)
    assert np.all(c_got - c_ref <= 5e-3)


def test_residual_decreases_with_iters(qqp):
    mesh = make_mesh(dp=4, tp=2)
    x0 = _x0_batch(8, seed=4)
    res = []
    for iters in (5, 80):
        solver = ShardedPGD(qqp, mesh, iters=iters)
        _, _, r = solver.solve(x0)
        res.append(float(r))
    assert res[1] < res[0]


def test_batch_sharding_layout(qqp):
    mesh = make_mesh(dp=4, tp=2)
    solver = ShardedPGD(qqp, mesh, iters=5)
    u0 = solver.init_words(16)
    # iterate is sharded over both axes
    assert len(u0.sharding.device_set) == 8


# ---------------------------------------------------------------------------
# dp x tp constrained (ALM) tier
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qcqp():
    from pint_jax.mpc.constrained import constrain_states, quantize_constrained

    T, dt = 48, 1.0 / 32.0
    qp = condense_double_integrator(T=T, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(
        qp,
        np.broadcast_to(A, (T, 2, 2)),
        np.broadcast_to(B, (T, 2, 1)),
        None,
        F=[[0.0, 1.0]],
        lo=-0.25,
        hi=0.25,
    )
    return quantize_constrained(sc, rho=50.0)


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_constrained_matches_single_device(qcqp, dp, tp):
    """The dp x tp ALM solve is bit-identical to ConstrainedPGD: both
    int32 psums (gradient + constraint evaluation) are exact, and the
    tp-replicated multiplier plane stays in lockstep."""
    from pint_jax.mpc.constrained import ConstrainedPGD
    from pint_jax.parallel import ShardedConstrainedPGD

    outer, inners = 6, 20
    mesh = make_mesh(dp=dp, tp=tp)
    sharded = ShardedConstrainedPGD(qcqp, mesh, outer=outer, inners=inners)
    single = ConstrainedPGD(qcqp, outer=outer, inners=inners)

    x0 = _x0_batch(16, seed=7)
    words_s, u_s, lam_s = sharded.solve(x0)
    words_1, u_1, lam_1 = single.solve(x0)

    np.testing.assert_array_equal(np.asarray(words_s), np.asarray(words_1))
    np.testing.assert_array_equal(np.asarray(u_s), np.asarray(u_1))
    np.testing.assert_array_equal(np.asarray(lam_s), np.asarray(lam_1))


def test_sharded_constrained_warm_multipliers(qcqp):
    """The lam0 warm-start plane shards dp / replicates tp and matches the
    single-device warm-started path exactly."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pint_jax.mpc.constrained import ConstrainedPGD
    from pint_jax.parallel import ShardedConstrainedPGD

    mesh = make_mesh(dp=2, tp=4)
    sharded = ShardedConstrainedPGD(qcqp, mesh, outer=3, inners=10)
    single = ConstrainedPGD(qcqp, outer=3, inners=10)
    x0 = _x0_batch(8, seed=11)

    # first pass produces multipliers; second pass warm-starts from them
    _, _, lam = sharded.solve(x0)
    g = jax.device_put(
        jnp.asarray(qcqp.qqp.g_lane_fixed(x0)),
        NamedSharding(mesh, P("dp", "tp")),
    )
    c = jax.device_put(
        jnp.asarray(qcqp.c_off_pre(x0)), NamedSharding(mesh, P("dp", None))
    )
    w2, lam2 = sharded.solve_words(sharded.init_words(8), g, c, lam)

    g1 = jnp.asarray(qcqp.qqp.g_lane_fixed(x0))
    c1 = jnp.asarray(qcqp.c_off_pre(x0))
    _, lam_1 = jax.jit(single.solve_words)(single.init_words(8), g1, c1)
    w2_1, lam2_1 = jax.jit(single.solve_words)(
        single.init_words(8), g1, c1, jnp.asarray(lam)
    )
    np.testing.assert_array_equal(np.asarray(lam), np.asarray(lam_1))
    np.testing.assert_array_equal(np.asarray(w2), np.asarray(w2_1))
    np.testing.assert_array_equal(np.asarray(lam2), np.asarray(lam2_1))


def test_sharded_constrained_rejects_bad_tp():
    """A padded horizon that doesn't split into 4-lane words per tp rank is
    rejected at construction."""
    from pint_jax.mpc.constrained import constrain_states, quantize_constrained
    from pint_jax.parallel import ShardedConstrainedPGD

    T, dt = 12, 1.0 / 32.0
    qp = condense_double_integrator(T=T, dt=dt)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(
        qp,
        np.broadcast_to(A, (T, 2, 2)),
        np.broadcast_to(B, (T, 2, 1)),
        None,
        F=[[0.0, 1.0]],
        lo=-0.25,
        hi=0.25,
    )
    q = quantize_constrained(sc, pad_to=4)  # padded = 12; 4*tp=32 doesn't fit
    assert q.qqp.padded % 32
    with pytest.raises(ValueError, match="must divide"):
        ShardedConstrainedPGD(q, make_mesh(dp=1, tp=8))
