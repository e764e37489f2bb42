"""Single-launch PGD kernels (mpc/fused.py) in the Pallas interpreter:
bit-identity to the XLA solvers they replace, the zero padding of the
horizon and the batch, the dp-sharded path, and how the gates resolve.

The kernels are integer end to end, so identity is exact (word for
word).  On the card the same checks run compiled (tests/test_gpu.py and
``chip_smoke.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax.models.dynamics import pack_controls, unpack_controls
from pint_jax.mpc import (
    DeviceSQP,
    FixedPointPGD,
    condense_double_integrator,
    quantize,
)
from pint_jax.mpc import fused as F
from pint_jax.mpc.accelerated import AcceleratedPGD
from pint_jax.mpc.fused import FusedPGD, pgd_fused_words
from pint_jax.mpc.ltv import _pgd_batched_h


@pytest.fixture(scope="module")
def qqp():
    return quantize(condense_double_integrator(T=50))


@functools.lru_cache(maxsize=None)
def _qqp_tp(Tp: int):
    """QP whose padded horizon is exactly ``Tp`` (100 stays 100 and the
    kernel pads it to 128)."""
    return quantize(condense_double_integrator(T=Tp), pad_to=4)


def _g(qqp, batch, seed):
    rng = np.random.default_rng(seed)
    x0 = np.stack(
        [rng.uniform(-3, 3, batch), rng.uniform(-1, 1, batch)], axis=-1
    )
    return jnp.asarray(qqp.g_lane_fixed(x0))


def _per_problem_ops(B, Tp, seed):
    rng = np.random.default_rng(seed)
    Hq = jnp.asarray(rng.integers(-127, 128, (B, Tp, Tp)), jnp.int8)
    lanes = jnp.asarray(rng.integers(-127, 128, (B, Tp)), jnp.int32)
    g = jnp.asarray(rng.integers(-10**6, 10**6, (B, Tp)), jnp.int32)
    num = jnp.asarray(rng.integers(500, 3000, (B,)), jnp.int32)
    den = jnp.asarray(rng.integers(14, 20, (B,)), jnp.int32)
    return pack_controls(lanes), g, Hq, num, den


def _x0_unicycle(B, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
         rng.uniform(0, 1, B)], axis=-1).astype(np.float32)


_SQP = dict(horizon=8, sqp_iters=2, pgd_iters=6,
            x_ref=np.array([1.0, 0.0, 0.0]))


def test_word_lane_roundtrip():
    rng = np.random.default_rng(0)
    lanes = rng.integers(-128, 128, size=(32, 64), dtype=np.int32)
    words = pack_controls(jnp.asarray(lanes))
    back = unpack_controls(words)
    np.testing.assert_array_equal(np.asarray(back), lanes)


@pytest.mark.parametrize("batch", [16, 100, 512])
def test_fused_matches_reference_solver(qqp, batch):
    iters = 30
    fused = FusedPGD(qqp, iters=iters, block_rows=128, interpret=True)
    word_solver = FixedPointPGD(qqp, iters=iters)
    g = _g(qqp, batch, 1)
    u0 = fused.init_words(batch)

    got = fused.solve_words(u0, g)
    expected = jax.jit(word_solver.solve_words)(u0, g)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(expected))


@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("batch", [1, 37, 300])
@pytest.mark.parametrize("Tp", [32, 64, 100, 256])
def test_fused_pgd_widths(Tp, batch, momentum):
    """Shared-Hessian kernel over horizons that are and are not powers of
    two, and batches that do not fill a block, against FixedPointPGD
    (AcceleratedPGD with momentum)."""
    qqp = _qqp_tp(Tp)
    assert qqp.padded == Tp
    iters = 6
    fused = FusedPGD(qqp, iters=iters, momentum=momentum, interpret=True)
    ref = (AcceleratedPGD if momentum else FixedPointPGD)(qqp, iters=iters)
    g = _g(qqp, batch, Tp + batch)
    u0 = fused.init_words(batch)
    np.testing.assert_array_equal(
        np.asarray(fused.solve_words(u0, g)),
        np.asarray(jax.jit(ref.solve_words)(u0, g)),
    )


@pytest.mark.parametrize("batch", [1, 37, 300])
@pytest.mark.parametrize("Tp", [32, 64, 100, 256])
def test_pgd_fused_widths(Tp, batch):
    """Per-problem kernel against ``_pgd_batched_h`` on random int8
    Hessians and error-feedback state."""
    if batch == 300 and Tp == 256:
        batch = 40   # same padding pattern, a quarter of the interpret time
    ops = _per_problem_ops(batch, Tp, Tp * 7 + batch)
    np.testing.assert_array_equal(
        np.asarray(pgd_fused_words(*ops, iters=5, g_shift=12,
                                   interpret=True)),
        np.asarray(_pgd_batched_h(*ops, iters=5, g_shift=12)),
    )


def test_padding_is_exact():
    """Zero rows/columns appended to the horizon and zero problems
    appended to the batch leave the real lanes unchanged and the padded
    lanes at zero."""
    B, Tp = 5, 100
    w, g, Hq, num, den = _per_problem_ops(B, Tp, 3)
    got = pgd_fused_words(w, g, Hq, num, den, iters=6, g_shift=12,
                          block=4, interpret=True)
    Bp, Tq = 8, 128
    lanes = F._pad_to(unpack_controls(w), (Bp, Tq))
    padded = pgd_fused_words(
        pack_controls(lanes), F._pad_to(g, (Bp, Tq)),
        F._pad_to(Hq, (Bp, Tq, Tq)), F._pad_to(num, (Bp,)),
        F._pad_to(den, (Bp,)), iters=6, g_shift=12, block=4,
        interpret=True,
    )
    out = np.asarray(unpack_controls(padded))
    np.testing.assert_array_equal(
        out[:B, :Tp], np.asarray(unpack_controls(got))
    )
    assert not out[:B, Tp:].any() and not out[B:].any()


def test_pad_helpers():
    assert [F._pow2(n) for n in (1, 2, 3, 16, 17, 100, 256)] == [
        1, 2, 4, 16, 32, 128, 256]
    x = jnp.ones((3, 5), jnp.int32)
    y = F._pad_to(x, (4, 8))
    assert y.shape == (4, 8) and int(y.sum()) == 15
    assert F._pad_to(x, (3, 5)) is x
    with pytest.raises(ValueError, match="power of two"):
        FusedPGD(quantize(condense_double_integrator(T=8)), block_rows=24)


def test_dp_sharded_fused_matches(qqp):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pint_jax.parallel import make_mesh

    mesh = make_mesh(dp=8, tp=1)
    fused = FusedPGD(qqp, iters=20, block_rows=32, interpret=True)
    batch = 64
    g = _g(qqp, batch, 5)
    u0 = fused.init_words(batch)
    sh = NamedSharding(mesh, P("dp", None))
    out = fused.dp_sharded(mesh)(
        jax.device_put(u0, sh), jax.device_put(g, sh)
    )
    ref = jax.jit(FixedPointPGD(qqp, iters=20).solve_words)(u0, g)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    assert len(out.sharding.device_set) == 8


@pytest.mark.parametrize("block", [4, 8])  # 8: B=12 pads to 16
def test_pgd_fused_bit_identical(block):
    d0 = DeviceSQP(**_SQP, fused=False)
    rng = np.random.default_rng(5)
    B = 12
    x0 = jnp.asarray(_x0_unicycle(B, 5))
    lanes0 = jnp.asarray(
        rng.integers(-100, 100, (B, d0.n_dec), dtype=np.int32))
    Hq, g_pre, hs_num, hs_den = jax.jit(d0._condense_dev)(x0, lanes0)
    u0 = d0.init_words(B)
    w1 = _pgd_batched_h(u0, g_pre, Hq, hs_num, hs_den,
                        iters=6, g_shift=d0.g_shift)
    w2 = pgd_fused_words(u0, g_pre, Hq, hs_num, hs_den, iters=6,
                         g_shift=d0.g_shift, block=block, interpret=True)
    assert jnp.array_equal(w1, w2)


def test_device_sqp_fused_solver_bit_identical():
    d0 = DeviceSQP(**_SQP, fused=False)
    d1 = DeviceSQP(**_SQP, fused=True, fused_block=8, interpret=True)
    x0 = _x0_unicycle(6, 13)
    u0 = d0.init_words(6)
    assert jnp.array_equal(d0.solve_words(u0, x0), d1.solve_words(u0, x0))


def _mesh(dp, tp):
    from pint_jax.parallel import make_mesh

    return make_mesh(dp=dp, tp=tp)


def test_sharded_fused_device_sqp_bit_identical():
    """The fused PGD inner inside shard_map (dp-major mesh) reproduces the
    single-device fused solve word for word."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    dev = DeviceSQP(**_SQP, fused=True, fused_block=8, interpret=True)
    B = 16
    x0 = _x0_unicycle(B, 17)
    u0 = dev.init_words(B)
    w_single = dev.solve_words(u0, x0)

    mesh = _mesh(8, 1)
    solve = dev.sharded_solve_words(mesh)
    xj = jax.device_put(jnp.asarray(x0), NamedSharding(mesh, P("dp", None)))
    uj = jax.device_put(u0, NamedSharding(mesh, P("dp", "tp")))
    assert jnp.array_equal(w_single, solve(uj, xj))


def test_sharded_fused_flag_ignored_on_tp_meshes(monkeypatch):
    """fused=True on a tp>1 mesh must NOT take the one-launch kernel (the
    per-iteration psum cannot live inside one kernel) and still match the
    single-device solve bit for bit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def boom(*a, **k):
        raise AssertionError("fused inner must not run on tp>1 meshes")

    monkeypatch.setattr(F, "pgd_fused_words", boom)
    dev = DeviceSQP(**_SQP, fused=True, interpret=True)
    B = 8
    x0 = _x0_unicycle(B, 23)
    u0 = dev.init_words(B)
    w_single = DeviceSQP(**_SQP, fused=False).solve_words(u0, x0)

    mesh = _mesh(2, 4)
    solve = dev.sharded_solve_words(mesh)
    xj = jax.device_put(jnp.asarray(x0), NamedSharding(mesh, P("dp", None)))
    uj = jax.device_put(u0, NamedSharding(mesh, P("dp", "tp")))
    assert jnp.array_equal(w_single, solve(uj, xj))


def test_auto_gates_pick_xla_off_gpu(qqp):
    from pint_jax.mpc import LTIController, RecedingHorizonController
    from pint_jax.serving import MPCService

    assert not F.route_compiles()
    assert DeviceSQP(horizon=32)._use_fused() is False
    assert isinstance(MPCService(qqp, batch=4)._solver, FixedPointPGD)
    assert not RecedingHorizonController.build(horizon=8).use_fused
    assert LTIController.__dataclass_fields__["use_fused"].default is False


def test_auto_gates_pick_kernel_on_gpu(qqp, monkeypatch):
    """With a GPU backend MPCService selects the shared-Hessian kernel and
    DeviceSQP the per-problem kernel inner (both bit-identical to the XLA
    solvers and measured to win); an explicit False keeps XLA."""
    from pint_jax.serving import MPCService

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert F.route_compiles()
    assert isinstance(MPCService(qqp, batch=4)._solver, FusedPGD)
    assert not isinstance(
        MPCService(qqp, batch=4, use_fused=False)._solver, FusedPGD)
    assert DeviceSQP(horizon=32)._use_fused() is F.PGD_FUSED_WINS
    assert DeviceSQP(horizon=32, fused=False)._use_fused() is False


def test_kernel_raises_where_route_cannot_compile(qqp):
    """A kernel asked for off the GPU raises instead of silently running
    in the interpreter."""
    fused = FusedPGD(qqp, iters=2)
    with pytest.raises(RuntimeError, match="interpret=True"):
        fused.solve_words(fused.init_words(4), _g(qqp, 4, 0))
    with pytest.raises(RuntimeError, match="compile only for a GPU"):
        pgd_fused_words(*_per_problem_ops(2, 8, 0), iters=2, g_shift=12)
    dev = DeviceSQP(**_SQP, fused=True)
    with pytest.raises(RuntimeError, match="Triton"):
        dev.solve_words(dev.init_words(2), _x0_unicycle(2, 0))
