"""Device-resident SQP: the whole nonlinear-MPC loop as one XLA program."""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models import Pendulum
from pint_jax.mpc import DeviceSQP, QuantizedSQP


@pytest.fixture(scope="module")
def pair():
    kw = dict(
        horizon=32, sqp_iters=6, pgd_iters=40,
        Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
        qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
    )
    return QuantizedSQP(**kw), DeviceSQP(**kw)


@pytest.fixture(scope="module")
def x0():
    return np.array(
        [[0.0, 0.0, 0.0], [-0.1, 0.05, 0.1], [0.05, -0.1, 0.9]]
    )


def test_device_matches_host_path(pair, x0):
    """f32 on-device condensation + power-iteration Lipschitz tracks the
    f64 host path to a fraction of a percent in final true cost."""
    host, dev = pair
    _, host_costs = host.solve(x0)
    words, _ = dev.solve(x0)
    dev_costs = host.true_cost(x0, host.lanes(words))
    np.testing.assert_allclose(
        dev_costs, host_costs[:, -1], rtol=0.01, atol=1e-4
    )


def test_device_sqp_deterministic(pair, x0):
    _, dev = pair
    w1, _ = dev.solve(x0)
    w2, _ = dev.solve(x0)
    np.testing.assert_array_equal(np.asarray(w1), np.asarray(w2))


def test_device_sqp_one_program(pair, x0):
    """The full solve traces into a single jitted call (no per-iteration
    host transfers): the jitted function is cached on the instance."""
    _, dev = pair
    f1 = dev._solve_jit
    f2 = dev._solve_jit
    assert f1 is f2


def test_device_swingup():
    m = Pendulum()
    dev = DeviceSQP(
        model=m, horizon=128, sqp_iters=8, pgd_iters=60,
        Q=np.diag([1.0, 0.05]), R=np.array([[0.05]]),
        qf_scale=80.0, x_ref=np.zeros(2),
    )
    words, plans = dev.solve(np.array([[0.5, 0.0]]))
    traj = m.reference_rollout(np.array([0.5, 0.0]), plans[0])
    assert abs(traj[-1, 0]) < 0.1 and abs(traj[-1, 1]) < 0.3, traj[-1]


def test_device_sqp_warm_start(pair, x0):
    """Warm-starting from a previous solution keeps it (near) fixed."""
    host, dev = pair
    w1, _ = dev.solve(x0)
    w2 = dev.solve_words(w1, x0.astype(np.float32))
    c1 = host.true_cost(x0, host.lanes(w1))
    c2 = host.true_cost(x0, host.lanes(w2))
    assert (c2 <= c1 * 1.01 + 1e-6).all(), (c1, c2)


def test_device_sqp_packing_validated():
    with pytest.raises(ValueError, match="multiple of 4"):
        DeviceSQP(model=Pendulum(), horizon=30, Q=np.eye(2),
                  R=np.array([[0.1]]), x_ref=np.zeros(2))


def test_device_sqp_dp_sharded_bit_identical(pair):
    """shard_map over a dp mesh reproduces the single-device solve exactly
    (the whole loop is batch-parallel; integer arithmetic is exact)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pint_jax.parallel import make_mesh

    _, dev = pair
    rng = np.random.default_rng(3)
    batch = 32
    x0 = np.stack(
        [
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(0, 1, batch),
        ],
        axis=-1,
    ).astype(np.float32)
    w_single, _ = dev.solve(x0)
    mesh = make_mesh(dp=8, tp=1)
    spec = P(("dp", "tp"), None)
    xj = jax.device_put(jnp.asarray(x0), NamedSharding(mesh, spec))
    u0 = jax.device_put(
        dev.init_words(batch), NamedSharding(mesh, spec)
    )
    sharded = jax.jit(
        jax.shard_map(
            dev.solve_words, mesh=mesh, in_specs=(spec, spec),
            out_specs=spec,
        )
    )
    w_sh = sharded(u0, xj)
    np.testing.assert_array_equal(np.asarray(w_single), np.asarray(w_sh))


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 4), (1, 8)])
def test_device_sqp_dp_tp_sharded_bit_identical(pair, dp, tp):
    """sharded_solve_words on a dp x tp mesh reproduces the single-device
    solve exactly: the PGD gradient psum is exact int32, the per-outer
    all_gather of the lane plan is exact, and the tp-replicated f32
    condensation sees identical inputs on every rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pint_jax.parallel import make_mesh

    _, dev = pair
    rng = np.random.default_rng(5)
    batch = 16
    x0 = np.stack(
        [
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(0, 1, batch),
        ],
        axis=-1,
    ).astype(np.float32)
    w_single, _ = dev.solve(x0)
    mesh = make_mesh(dp=dp, tp=tp)
    solve = dev.sharded_solve_words(mesh)
    xj = jax.device_put(
        jnp.asarray(x0), NamedSharding(mesh, P("dp", None))
    )
    u0 = jax.device_put(
        dev.init_words(batch), NamedSharding(mesh, P("dp", "tp"))
    )
    w_sh = solve(u0, xj)
    np.testing.assert_array_equal(np.asarray(w_single), np.asarray(w_sh))


def test_device_sqp_sharded_rejects_bad_tp():
    from pint_jax.parallel import make_mesh

    # unicycle horizon 36 -> n_dec = 72, not divisible by 4*tp = 32
    bad = DeviceSQP(horizon=36, sqp_iters=1, pgd_iters=1)
    with pytest.raises(ValueError, match="divide into 4-lane"):
        bad.sharded_solve_words(make_mesh(dp=1, tp=8))


@pytest.mark.parametrize("model_n", [(None, 3), ("pendulum", 2)])
def test_propagate_paths_agree(model_n, pair):
    """The closed-form all-pairs condensation (suffix-sum H/g, no
    propagator tensor) agrees with the sequential scan + reduce path to
    f32 roundoff on the condensed (H, g), and the quantized end-to-end
    solves land within one int8 lane step of each other."""
    name, n = model_n
    kw = dict(horizon=16, sqp_iters=2, pgd_iters=10)
    if name == "pendulum":
        kw.update(model=Pendulum(), Q=np.diag([1.0, 0.05]),
                  R=np.array([[0.05]]), x_ref=np.zeros(2))
    d_new = DeviceSQP(**kw, propagate="allpairs")
    d_old = DeviceSQP(**kw, propagate="scan")
    rng = np.random.default_rng(0)
    batch = 8
    x0 = jnp.asarray(rng.normal(size=(batch, n)) * 0.5, jnp.float32)
    lanes = jnp.asarray(
        rng.integers(-40, 40, size=(batch, d_new.n_dec)), jnp.int32
    )
    for a, b in zip(d_new._condense_hg(x0, lanes),
                    d_old._condense_hg(x0, lanes)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * (np.abs(b).max() + 1e-12)
    from pint_jax.models.dynamics import unpack_controls
    w_new = d_new.solve_words(d_new.init_words(batch), x0)
    w_old = d_old.solve_words(d_old.init_words(batch), x0)
    l_new = np.asarray(unpack_controls(w_new), np.int64)
    l_old = np.asarray(unpack_controls(w_old), np.int64)
    l_new = (l_new + 128) % 256 - 128  # uint lanes -> signed
    l_old = (l_old + 128) % 256 - 128
    assert np.abs(l_new - l_old).max() <= 1


@pytest.mark.parametrize("mode", ["magic", "auto", "unroll"])
def test_propagate_validated(mode):
    with pytest.raises(ValueError, match="propagate"):
        DeviceSQP(propagate=mode)


def test_device_sqp_nan_input_isolated(pair):
    """A corrupted (NaN) problem neither crashes the batch nor perturbs
    its companions (the non-finite guard mirrors the host path)."""
    _, dev = pair
    good = np.array([[0.1, -0.05, 0.2]], np.float32)
    bad = np.array([[np.nan, 0.0, 0.0]], np.float32)
    both = np.concatenate([good, bad])
    w_both, _ = dev.solve(both)
    w_solo, _ = dev.solve(good)
    np.testing.assert_array_equal(np.asarray(w_both)[0], np.asarray(w_solo)[0])
    assert np.asarray(w_both).dtype == np.uint32  # finite packed words


@pytest.mark.parametrize("form", ["bogus", "blocked", "btrans"])
def test_bad_reduce_rejected(form):
    with pytest.raises(ValueError, match="reduce must be"):
        DeviceSQP(horizon=8, reduce=form)


def test_reduce_sym_agrees(pair):
    """The symmetric-square contraction (reduce="sym": Ht = W^T W with
    W = L^T-weighted stacks, Q = L L^T) agrees with the einsum path to
    f32 roundoff on (H, g), and end-to-end solves land within one lane
    step.  Also exercises the PSD-sqrt guard."""
    import jax.numpy as jnp

    kw = dict(horizon=16, sqp_iters=2, pgd_iters=10)
    d_sym = DeviceSQP(**kw, reduce="sym")
    d_ein = DeviceSQP(**kw, reduce="einsum")
    rng = np.random.default_rng(5)
    B = 8
    x0 = jnp.asarray(rng.normal(size=(B, 3)) * 0.5, jnp.float32)
    lanes = jnp.asarray(
        rng.integers(-40, 40, size=(B, d_sym.n_dec)), jnp.int32
    )
    for a, b in zip(d_sym._condense_hg(x0, lanes),
                    d_ein._condense_hg(x0, lanes)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * (np.abs(b).max() + 1e-12)
    from pint_jax.models.dynamics import unpack_controls

    w_s = d_sym.solve_words(d_sym.init_words(B), x0)
    w_e = d_ein.solve_words(d_ein.init_words(B), x0)
    l_s = (np.asarray(unpack_controls(w_s), np.int64) + 128) % 256 - 128
    l_e = (np.asarray(unpack_controls(w_e), np.int64) + 128) % 256 - 128
    assert np.abs(l_s - l_e).max() <= 1

    # correlated (non-diagonal) PSD Q exercises the eigh factor with
    # off-diagonal terms: still f32-roundoff agreement with einsum
    A = np.array([[1.0, 0.3, 0.0], [0.0, 0.8, 0.2], [0.1, 0.0, 0.4]])
    Qc = A @ A.T
    dc_s = DeviceSQP(**kw, reduce="sym", Q=Qc)
    dc_e = DeviceSQP(**kw, reduce="einsum", Q=Qc)
    for a, b in zip(dc_s._condense_hg(x0, lanes),
                    dc_e._condense_hg(x0, lanes)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.abs(a - b).max() <= 1e-4 * (np.abs(b).max() + 1e-12)

    # semidefinite Q (zero weight on a state) still factors
    d0 = DeviceSQP(**kw, reduce="sym", Q=np.diag([1.0, 1.0, 0.0]))
    d0._condense_hg(x0, lanes)
    # indefinite Q is rejected with a clear message
    with pytest.raises(ValueError, match="PSD"):
        DeviceSQP(**kw, reduce="sym", Q=np.diag([1.0, 1.0, -0.5]))._Q_sqrt


@pytest.mark.parametrize("shape_a,shape_b,axis,spec", [
    ((5, 3, 4), (5, 1, 4), 0, "kij,kij->ij"),
    ((3, 7, 2), (1, 7, 2), 1, "ikj,ikj->ij"),
    ((4, 6), (4, 6), 0, "ki,ki->i"),
])
def test_fold_dot_matches_einsum(shape_a, shape_b, axis, spec):
    """The fold contraction is the einsum it replaces, to f32 roundoff,
    and sums in index order (a left fold)."""
    from pint_jax.mpc.device_sqp import _fold_dot, _fold_sum

    rng = np.random.default_rng(len(shape_a) + axis)
    a = rng.normal(size=shape_a).astype(np.float32)
    b = rng.normal(size=shape_b).astype(np.float32)
    got = np.asarray(_fold_dot(jnp.asarray(a), jnp.asarray(b), axis=axis))
    want = np.einsum(spec, a, np.broadcast_to(b, a.shape).astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # left fold: ((x0 + x1) + x2) + ...  in f32
    x = np.array([1.0, 2.0**-24, 2.0**-24, -1.0], np.float32)
    assert float(_fold_sum(jnp.asarray(x))) == 0.0


@pytest.mark.parametrize("reduce", ["sym", "einsum"])
def test_condensation_batch_invariant(reduce):
    """Each problem's quantized operands are the same bits whether it is
    condensed alone, in a small batch or in a larger one: the
    condensation's contractions are folds, not shape-tuned dots or
    reductions (docs/DESIGN.md section 11, D4)."""
    import jax

    dev = DeviceSQP(horizon=16, sqp_iters=1, pgd_iters=4, reduce=reduce,
                    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
                    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]))
    rng = np.random.default_rng(23)
    B = 24
    x0 = jnp.asarray(np.stack(
        [rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
         rng.uniform(0, 1, B)], axis=-1), jnp.float32)
    lanes = jnp.asarray(rng.integers(-100, 100, (B, dev.n_dec)), jnp.int32)
    cond = jax.jit(dev._condense_dev)
    full = cond(x0, lanes)
    for k in (1, 5):
        for got, ref in zip(cond(x0[:k], lanes[:k]), full):
            np.testing.assert_array_equal(np.asarray(got),
                                          np.asarray(ref)[:k])
