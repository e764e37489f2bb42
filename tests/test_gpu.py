"""Card-only checks: the kernels compiled for the GPU (no interpreter)
against their plain references, the elementwise entry points against the
exact oracle on the device, and the auto gates as the card resolves them.

Every test takes the ``gpu`` fixture, which skips where the default
backend is not a GPU.  ``chip_smoke.py`` runs them in its own process on
the card; by hand: ``PINT_GPU_TESTS=1 python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax import PackedLayout
from pint_jax.models.dynamics import pack_controls
from pint_jax.mpc import (
    DeviceSQP,
    FixedPointPGD,
    condense_double_integrator,
    quantize,
)
from pint_jax.mpc.accelerated import AcceleratedPGD
from pint_jax.mpc.fused import FusedPGD, pgd_fused_words
from pint_jax.mpc.ltv import _pgd_batched_h
from pint_jax.ops import elementwise as E
from pint_jax.utils.oracle import Oracle

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("momentum", [False, True])
def test_fused_pgd_compiled_matches_reference(gpu, momentum):
    qqp = quantize(condense_double_integrator(T=50))
    rng = np.random.default_rng(0)
    B = 333
    x0 = np.stack([rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], axis=-1)
    g = jnp.asarray(qqp.g_lane_fixed(x0))
    fused = FusedPGD(qqp, iters=20, momentum=momentum)
    ref = (AcceleratedPGD if momentum else FixedPointPGD)(qqp, iters=20)
    u0 = fused.init_words(B)
    got = fused.solve_words(u0, g)
    assert got.devices() == {gpu}
    np.testing.assert_array_equal(
        np.asarray(got), np.asarray(jax.jit(ref.solve_words)(u0, g))
    )


@pytest.mark.parametrize("Tp", [64, 100])
def test_pgd_fused_compiled_matches_xla(gpu, Tp):
    rng = np.random.default_rng(Tp)
    B = 37
    Hq = jnp.asarray(rng.integers(-127, 128, (B, Tp, Tp)), jnp.int8)
    lanes = jnp.asarray(rng.integers(-127, 128, (B, Tp)), jnp.int32)
    g = jnp.asarray(rng.integers(-10**6, 10**6, (B, Tp)), jnp.int32)
    num = jnp.asarray(rng.integers(500, 3000, (B,)), jnp.int32)
    den = jnp.asarray(rng.integers(14, 20, (B,)), jnp.int32)
    ops = (pack_controls(lanes), g, Hq, num, den)
    np.testing.assert_array_equal(
        np.asarray(pgd_fused_words(*ops, iters=9, g_shift=12)),
        np.asarray(_pgd_batched_h(*ops, iters=9, g_shift=12)),
    )


def test_device_sqp_fused_inner_compiled_matches_xla(gpu):
    """The kernel inner on one real condensation's operands equals the
    XLA inner bit for bit."""
    dev = DeviceSQP(horizon=32, sqp_iters=2, pgd_iters=30,
                    Q=np.diag([1.0, 1.0, 0.005]),
                    R=np.diag([0.005, 0.005]), qf_scale=60.0,
                    x_ref=np.array([0.2, 0.1, 0.0]))
    rng = np.random.default_rng(3)
    B = 256
    x0 = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                   rng.uniform(0, 1, B)], axis=-1).astype(np.float32)
    lanes = jnp.asarray(rng.integers(-100, 100, (B, dev.n_dec)), jnp.int32)
    Hq, g_pre, num, den = jax.jit(dev._condense_dev)(x0, lanes)
    u0 = dev.init_words(B)
    kw = dict(iters=dev.pgd_iters, g_shift=dev.g_shift)
    np.testing.assert_array_equal(
        np.asarray(_pgd_batched_h(u0, g_pre, Hq, num, den, **kw)),
        np.asarray(pgd_fused_words(u0, g_pre, Hq, num, den, **kw)),
    )


def _sqp_case(B, seed):
    dev = DeviceSQP(horizon=32, sqp_iters=2, pgd_iters=30,
                    Q=np.diag([1.0, 1.0, 0.005]),
                    R=np.diag([0.005, 0.005]), qf_scale=60.0,
                    x_ref=np.array([0.2, 0.1, 0.0]), fused=False)
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B),
                   rng.uniform(0, 1, B)], axis=-1).astype(np.float32)
    return dev, x0


def test_device_sqp_fused_solve_compiled_matches_xla(gpu):
    """Whole solves with the kernel inner equal XLA-inner solves bit for
    bit: the fold condensation compiles to the same bits around either
    inner."""
    import dataclasses

    dev, x0 = _sqp_case(512, 4)
    u0 = dev.init_words(512)
    kern = dataclasses.replace(dev, fused=True)
    np.testing.assert_array_equal(
        np.asarray(dev.solve_words(u0, x0)),
        np.asarray(kern.solve_words(u0, x0)),
    )


def test_device_sqp_condensation_batch_invariant_on_card(gpu):
    """Each problem's quantized operands are the same bits in a batch of
    64 and of 512 on the card (no shape-chosen dot or reduction)."""
    dev, x0 = _sqp_case(512, 5)
    rng = np.random.default_rng(6)
    lanes = jnp.asarray(rng.integers(-100, 100, (512, dev.n_dec)), jnp.int32)
    cond = jax.jit(dev._condense_dev)
    for got, ref in zip(cond(x0[:64], lanes[:64]), cond(x0, lanes)):
        np.testing.assert_array_equal(np.asarray(got),
                                      np.asarray(ref)[:64])


@pytest.mark.parametrize("opname", E.BINOP_NAMES)
def test_elementwise_on_card_matches_oracle(gpu, opname):
    rng = np.random.default_rng(11)
    for layout in (PackedLayout(8, 8, 8, 8), PackedLayout(1, 2, 3, 4, 5, 6, 11)):
        a = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
             & np.uint64(layout.used_mask)).astype(np.uint32)
        b = (rng.integers(0, 1 << 32, 4096, dtype=np.uint64)
             & np.uint64(layout.used_mask)).astype(np.uint32)
        got = E.binop(layout, opname)(jnp.asarray(a), jnp.asarray(b))
        assert got.devices() == {gpu}
        expected = getattr(Oracle(layout), opname)(a, b)
        np.testing.assert_array_equal(
            np.asarray(got).astype(np.uint64), np.asarray(expected, np.uint64)
        )


def test_auto_gates_on_card(gpu):
    from pint_jax.mpc import fused as F
    from pint_jax.serving import MPCService

    assert F.route_compiles()
    assert DeviceSQP(horizon=32)._use_fused() == F.PGD_FUSED_WINS
    svc = MPCService(quantize(condense_double_integrator(T=50)), batch=8)
    assert isinstance(svc._solver, FusedPGD) == F.FUSED_PGD_WINS
    assert svc.g_on_device
