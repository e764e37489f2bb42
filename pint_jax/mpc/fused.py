"""Pallas kernels for the fixed-point PGD loops, through the Triton route.

The plain solvers (:class:`pint_jax.mpc.solver.FixedPointPGD` and
:func:`pint_jax.mpc.ltv._pgd_batched_h`) lower to an XLA ``fori_loop``:
every iteration launches its kernels again and round-trips the int32
iterate, the gradient and the step through device memory, and the
per-problem form re-reads every problem's int8 Hessian as well.  XLA
cannot fuse across loop iterations.  The kernels here run the whole loop
inside one launch:

* :class:`FusedPGD` -- one Hessian shared by every problem (the LTI
  tier).  A program owns a block of rows, loads the int8 Hessian once
  and runs every iteration in registers: an int8 ``pl.dot`` with int32
  accumulation, then rescale, then clip.
* :func:`pgd_fused_words` -- a Hessian per problem (the inner solve of
  :class:`~pint_jax.mpc.device_sqp.DeviceSQP`).  A program owns a few
  problems, loads their Hessians once and computes each matvec as a
  broadcast multiply and an int32 row sum.

Triton blocks have power-of-two sizes, so the horizon ``Tp`` and the
batch are zero-padded: a zero Hessian row and column, a zero linear term
and a zero start lane keep a padded lane at zero through every
iteration, and padded problems are dropped on the way out, so the
padding is exact in integers.

Exactness: for in-range int8 lanes, ``max_signed(add_signed_saturate(u,
d), -127)`` equals ``clip(u + d, -127, 127)`` in lane space -- int32 lane
adds cannot wrap, and the box floor re-clamps the -128 saturation
flooring -- and int32 accumulation wraps the same way in any order.  So
both kernels are bit-identical to the word-space solvers they replace
(tests/test_fused.py, and on the card in ``chip_smoke.py``).

Route and choice are two separate questions.  :func:`route_compiles`
says whether the Triton route compiles on the default backend (a GPU).
Whether a kernel is chosen is decided beside it: :data:`FUSED_PGD_WINS`
for :class:`FusedPGD`, :data:`PGD_FUSED_WINS` for :func:`pgd_fused_words`
(``DeviceSQP.fused``).  A kernel asked for where the route cannot compile
raises; ``interpret=True`` runs it in the Pallas interpreter instead,
which is how the CPU tests run it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from pint_jax.models.dynamics import pack_controls, unpack_controls
from pint_jax.mpc.condensed import QuantizedQP

Array = jax.Array

__all__ = ["FusedPGD", "FUSED_PGD_WINS", "PGD_FUSED_WINS",
           "pgd_fused_words", "route_compiles"]

FUSED_PGD_WINS = True
"""Whether :class:`FusedPGD` beats ``FixedPointPGD`` on the card.
Measured on an H100 80GB HBM3 (B=8192, Tp=64, 40 iterations): the
kernel solve takes 0.27 ms against the XLA loop's 0.67 ms at 400 W
(CHANGES.md records the numbers)."""

PGD_FUSED_WINS = True
"""Whether :func:`pgd_fused_words` beats the XLA inner end to end in a
``DeviceSQP`` solve.  Measured on an H100 80GB HBM3 (unicycle, T=32,
B=4096, 4x30): the solve takes 13.1 ms against 15.4 ms with the XLA inner
at 400 W, bit-identical (CHANGES.md records the numbers)."""

def route_compiles() -> bool:
    """True when the Pallas Triton route compiles on the default backend
    (a GPU).  Auto gates select a kernel only where this holds."""
    return jax.default_backend() == "gpu"


def _interpret(interpret: bool) -> bool:
    """``interpret`` resolved: True runs the Pallas interpreter; False
    compiles for the card, and raises where the route cannot compile
    instead of silently interpreting."""
    if interpret:
        return True
    if not route_compiles():
        raise RuntimeError(
            f"the fused PGD kernels compile only for a GPU (Pallas Triton "
            f"route); the default backend is {jax.default_backend()!r}. "
            f"Use the XLA solver here, or pass interpret=True to run the "
            f"kernel in the Pallas interpreter."
        )
    return False


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pad_to(x: Array, shape) -> Array:
    """Zero-pad ``x`` at the end of every axis up to ``shape``."""
    pads = [(0, s - d) for d, s in zip(x.shape, shape)]
    return jnp.pad(x, pads) if any(p for _, p in pads) else x


def _clip(x, lo: int, hi: int):
    return jnp.minimum(jnp.maximum(x, np.int32(lo)), np.int32(hi))


@dataclasses.dataclass(frozen=True)
class FusedPGD:
    """Single-launch PGD solver for a shared Hessian, bit-identical to
    :class:`~pint_jax.mpc.solver.FixedPointPGD` (and, with
    ``momentum=True``, to :class:`~pint_jax.mpc.accelerated.
    AcceleratedPGD`)."""

    qqp: QuantizedQP
    iters: int = 40
    block_rows: int = 64
    """Rows (problems) per program; a power of two, at least 16 (the
    smallest operand of a Triton int8 dot).  64 was fastest on the card
    among 32..256 (H100, B=8192, Tp=64)."""
    num_warps: int = 4
    momentum: bool = False
    """Nesterov-style extrapolation (see mpc/accelerated.py): ~3x fewer
    iterations at equal accuracy for the default QP's kappa~100."""
    beta_den: int = 8
    interpret: bool = False
    """Run the kernel in the Pallas interpreter (tests on the CPU)."""

    def __post_init__(self):
        br = self.block_rows
        if br < 16 or br & (br - 1):
            raise ValueError(
                f"block_rows must be a power of two >= 16, got {br}"
            )

    @functools.cached_property
    def _beta_num(self) -> int:
        eig = np.linalg.eigvalsh(self.qqp.qp.H)
        kappa = float(eig.max() / max(eig.min(), 1e-12))
        rk = np.sqrt(kappa)
        return int(round((rk - 1.0) / (rk + 1.0) * (1 << self.beta_den)))

    def _kernel(self, u_ref, g_ref, h_ref, out_ref):
        qqp = self.qqp
        hs_num = np.int32(qqp.hs_num)
        hs_den = np.int32(qqp.hs_den)
        g_shift = np.int32(qqp.g_shift)
        half = np.int32(1 << (qqp.g_shift - 1))
        h = h_ref[...]
        g = g_ref[...]

        def body(_, lanes):
            acc = pl.dot(lanes.astype(jnp.int8), h, trans_b=True)
            pre = (acc * hs_num) >> hs_den
            delta = _clip((half - (pre + g)) >> g_shift, -128, 127)
            return _clip(lanes + delta, -127, 127)

        x0 = u_ref[...]
        if not self.momentum:
            out_ref[...] = jax.lax.fori_loop(0, self.iters, body, x0)
            return
        bnum = np.int32(self._beta_num)
        bden = np.int32(self.beta_den)

        def mbody(i, carry):
            x, xp = carry
            y = _clip(x + ((bnum * (x - xp)) >> bden), -127, 127)
            return body(i, y), x

        out_ref[...] = jax.lax.fori_loop(0, self.iters, mbody, (x0, x0))[0]

    @functools.cached_property
    def _call(self):
        qqp = self.qqp
        Tp = qqp.padded
        Tq = _pow2(Tp)
        hq = np.zeros((Tq, Tq), np.int8)
        hq[:Tp, :Tp] = qqp.Hq
        interpret = _interpret(self.interpret)

        def run(u_words: Array, g_pre: Array) -> Array:
            batch = u_words.shape[0]
            br = min(self.block_rows, max(16, _pow2(batch)))
            rows = -(-batch // br) * br
            lanes = _pad_to(unpack_controls(u_words), (rows, Tq))
            g = _pad_to(g_pre, (rows, Tq))
            spec = pl.BlockSpec((br, Tq), lambda i: (i, 0))
            out = pl.pallas_call(
                self._kernel,
                out_shape=jax.ShapeDtypeStruct((rows, Tq), jnp.int32),
                grid=(rows // br,),
                in_specs=[spec, spec, pl.BlockSpec((Tq, Tq), lambda i: (0, 0))],
                out_specs=spec,
                backend="triton",
                compiler_params=plt.CompilerParams(
                    num_warps=self.num_warps, num_stages=1
                ),
                interpret=interpret,
                name="fused_pgd",
            )(lanes, g, jnp.asarray(hq))
            return pack_controls(out[:batch, :Tp])

        return jax.jit(run)

    # -- multi-device --------------------------------------------------------

    def dp_sharded(self, mesh):
        """jitted dp-sharded solve over ``mesh``: each device runs the
        kernel on its batch shard (no communication; bit-identical).  For
        tp sharding use :class:`pint_jax.parallel.ShardedPGD` (the
        gradient psum cannot live inside one kernel)."""
        from jax.sharding import PartitionSpec as P

        fn = jax.shard_map(
            lambda u, g: self.solve_words(u, g),
            mesh=mesh,
            in_specs=(P("dp", None), P("dp", None)),
            out_specs=P("dp", None),
            # values loaded inside a kernel carry no varying-manual-axes
            # tags, so the kernel's loop cannot pass shard_map's check
            check_vma=False,
        )
        return jax.jit(fn)

    # -- public API (mirrors FixedPointPGD) ---------------------------------

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.qqp.padded // 4), jnp.uint32)

    def solve_words(self, u_words: Array, g_pre: Array) -> Array:
        return self._call(u_words, g_pre)

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array]:
        g_pre = jnp.asarray(self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)))
        u0 = self.init_words(g_pre.shape[0])
        words = self.solve_words(u0, g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.astype(jnp.float32) * np.float32(self.qqp.u_scale)


def _pgd_kernel_factory(iters: int, g_shift: int):
    half = np.int32(1 << (g_shift - 1))
    g_shift = np.int32(g_shift)

    def kernel(lanes_ref, g_ref, hq_ref, num_ref, den_ref, out_ref):
        hq = hq_ref[...].astype(jnp.int32)             # (bb, Tq, Tq)
        g = g_ref[...]                                 # (bb, Tq)
        hs_num = num_ref[...][:, None]
        hs_den = den_ref[...][:, None]

        def body(_, st):
            lanes, carry = st
            acc = jnp.sum(hq * lanes[:, None, :], axis=2, dtype=jnp.int32)
            pre = (acc * hs_num) >> hs_den
            step = carry - (pre + g)
            delta = _clip((step + half) >> g_shift, -128, 127)
            carry = step - (delta << g_shift)
            return _clip(lanes + delta, -127, 127), carry

        out_ref[...] = jax.lax.fori_loop(
            0, iters, body, (lanes_ref[...], g ^ g)
        )[0]

    return kernel


def pgd_fused_words(
    u_words: Array,   # (B, Tp/4) uint32
    g_pre: Array,     # (B, Tp) int32
    Hq: Array,        # (B, Tp, Tp) int8 per-problem Hessian
    hs_num: Array,    # (B,) int32
    hs_den: Array,
    *,
    iters: int,
    g_shift: int,
    block: int = 2,
    num_warps: int = 4,
    interpret: bool = False,
) -> Array:
    """Single-launch replacement for :func:`pint_jax.mpc.ltv.
    _pgd_batched_h` (same operands and returns, bit-identical words).
    ``block`` problems per program, a power of two; 2 was fastest on the
    card among 1..8 at T=32 (H100, B=4096)."""
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    interpret = _interpret(interpret)
    B, Tp = g_pre.shape
    Tq = _pow2(Tp)
    rows = -(-B // block) * block
    lanes = _pad_to(unpack_controls(u_words), (rows, Tq))
    g = _pad_to(g_pre, (rows, Tq))
    hq = _pad_to(Hq, (rows, Tq, Tq))
    num = _pad_to(hs_num, (rows,))
    den = _pad_to(hs_den, (rows,))
    row = pl.BlockSpec((block, Tq), lambda i: (i, 0))
    scalar = pl.BlockSpec((block,), lambda i: (i,))
    out = pl.pallas_call(
        _pgd_kernel_factory(iters, g_shift),
        out_shape=jax.ShapeDtypeStruct((rows, Tq), jnp.int32),
        grid=(rows // block,),
        in_specs=[
            row, row, pl.BlockSpec((block, Tq, Tq), lambda i: (i, 0, 0)),
            scalar, scalar,
        ],
        out_specs=row,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="pgd_fused",
    )(lanes, g, hq, num, den)
    return pack_controls(out[:B, :Tp])
