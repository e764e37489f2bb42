"""u64 SWAR words as paired u32 halves, without x64.

64-bit layouts (``make_packed_int`` sums 33..64, pint.hpp:789-795 /
pint_test.cpp:82-87) need uint64 arrays, and so ``jax_enable_x64``, on the
plain jnp path.  This module runs them with x64 off: a 64-bit word is
represented as two u32 half-words
``(lo, hi)`` and all word arithmetic is expressed over the halves, with
carries/borrows propagated branch-free across the 32-bit seam.

The SWAR formulas themselves are **not** re-implemented here.
:class:`SplitWord` overloads the integer operators (``& | ^ ~ + - << >>``)
with exact mod-2^64 semantics, and :class:`SplitView` wraps a
:class:`~pint_jax.layout.PackedLayout` so that :mod:`pint_jax.ops.word`'s
mask-constant helper materializes constants as split pairs.  Every public
formula in ``word.py`` (the single home of the reference's branch-free
identities, pint.hpp:758-1031) then evaluates unchanged on split operands,
bit-identical to the (x64) u64 jnp path.

Cross-half primitives:

* add:   ``hi' = a.hi + b.hi + carry31`` where ``carry31`` is bit 31 of the
  reference's carry vector ``(a&b)|((a|b)&~(a+b))`` (pint.hpp:375-378)
  evaluated on the low halves -- the carry *out of* bit 31 is exactly the
  carry *into* the high half.
* sub:   borrow via the borrow vector ``(~a&b)|(~(a^b)&(a-b))``
  (pint.hpp:380-383), same bit-31 extraction.
* shifts by a traced amount k in [0, 64]: both the within-half and
  cross-half candidates are computed and blended with a compare-free
  ``(32-k) >> 31`` sign mask (the k == 32 boundary is agreement-safe:
  both candidates coincide there), mirroring the branch-free guard
  discipline of pint.hpp:1011-1013.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.layout import PackedLayout

Array = jax.Array

__all__ = ["SplitWord", "SplitView", "split_u64", "merge_u64"]

_U32 = np.dtype("uint32")
_MASK32 = 0xFFFFFFFF


def _shl32(x: Array, k) -> Array:
    """u32 left shift exact for k in [0, 32] (two-step, UB-free)."""
    k1 = jnp.minimum(k, np.uint32(31))
    return (x << k1) << (k - k1)


def _shr32(x: Array, k) -> Array:
    k1 = jnp.minimum(k, np.uint32(31))
    return (x >> k1) >> (k - k1)


def _sat0_u32(x: Array) -> Array:
    """0 if the u32 sign bit is set (i.e. negative as i32), else x."""
    return ((x >> np.uint32(31)) - np.uint32(1)) & x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SplitWord:
    """A u64 word tensor as two u32 half tensors ``(lo, hi)``.

    Operator overloads give exact mod-2^64 integer semantics so the
    ``word.py`` formulas evaluate on it unchanged.  Right-hand operands may
    be another :class:`SplitWord`, a Python/numpy integer (split into
    constant halves), or a u32 array (replicated into both halves -- used
    only for the 0/all-ones guard masks of the shift ops).
    """

    lo: Array
    hi: Array

    # -- pytree ------------------------------------------------------------
    def tree_flatten(self):
        return (self.lo, self.hi), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- construction --------------------------------------------------------
    @classmethod
    def const(cls, value: int) -> "SplitWord":
        value = int(value) & 0xFFFFFFFFFFFFFFFF
        return cls(
            jnp.uint32(value & _MASK32), jnp.uint32((value >> 32) & _MASK32)
        )

    def _coerce(self, other) -> "SplitWord":
        if isinstance(other, SplitWord):
            return other
        if isinstance(other, (int, np.integer)):
            return SplitWord.const(int(other))
        # u32 guard mask (0 or all-ones): same bits in both halves
        o = jnp.asarray(other)
        if o.dtype != _U32:
            raise TypeError(f"cannot mix SplitWord with {o.dtype}")
        return SplitWord(o, o)

    # -- bitwise -------------------------------------------------------------
    def __and__(self, o):
        o = self._coerce(o)
        return SplitWord(self.lo & o.lo, self.hi & o.hi)

    def __or__(self, o):
        o = self._coerce(o)
        return SplitWord(self.lo | o.lo, self.hi | o.hi)

    def __xor__(self, o):
        o = self._coerce(o)
        return SplitWord(self.lo ^ o.lo, self.hi ^ o.hi)

    __rand__ = __and__
    __ror__ = __or__
    __rxor__ = __xor__

    def __invert__(self):
        return SplitWord(~self.lo, ~self.hi)

    # -- add / sub with cross-half carry --------------------------------------
    def __add__(self, o):
        o = self._coerce(o)
        carry_vec = (self.lo & o.lo) | ((self.lo | o.lo) & ~(self.lo + o.lo))
        carry = carry_vec >> np.uint32(31)
        return SplitWord(self.lo + o.lo, self.hi + o.hi + carry)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        diff = self.lo - o.lo
        borrow_vec = (~self.lo & o.lo) | (~(self.lo ^ o.lo) & diff)
        borrow = borrow_vec >> np.uint32(31)
        return SplitWord(diff, self.hi - o.hi - borrow)

    # -- shifts by a static Python/numpy integer ------------------------------
    def __lshift__(self, k):
        k = int(k)
        if k == 0:
            return self
        if k >= 64:
            z = self.lo ^ self.lo
            return SplitWord(z, z)
        if k >= 32:
            return SplitWord(self.lo ^ self.lo, self.lo << np.uint32(k - 32))
        kk = np.uint32(k)
        return SplitWord(
            self.lo << kk, (self.hi << kk) | (self.lo >> np.uint32(32 - k))
        )

    def __rshift__(self, k):
        k = int(k)
        if k == 0:
            return self
        if k >= 64:
            z = self.lo ^ self.lo
            return SplitWord(z, z)
        if k >= 32:
            return SplitWord(self.hi >> np.uint32(k - 32), self.hi ^ self.hi)
        kk = np.uint32(k)
        return SplitWord(
            (self.lo >> kk) | (self.hi << np.uint32(32 - k)), self.hi >> kk
        )

    # -- shifts by a traced u32 amount in [0, 64] ------------------------------
    def shl_full(self, k) -> "SplitWord":
        """Exact mod-2^64 left shift for traced k in [0, 64], branch-free."""
        k = jnp.asarray(k).astype(_U32)
        kb = _sat0_u32(k - np.uint32(32))  # cross-half amount, 0 when k<=32
        ka = k - kb                        # within-half amount, min(k, 32)
        lo_out = _shl32(self.lo, ka)
        within_hi = _shl32(self.hi, ka) | _shr32(self.lo, np.uint32(32) - ka)
        cross_hi = _shl32(self.lo, kb)
        # all-ones iff k <= 32; at k == 32 both candidates equal lo
        m = (((np.uint32(32) - k) >> np.uint32(31)) - np.uint32(1))
        return SplitWord(lo_out & m, (within_hi & m) | (cross_hi & ~m))

    def shr_full(self, k) -> "SplitWord":
        """Exact mod-2^64 logical right shift for traced k in [0, 64]."""
        k = jnp.asarray(k).astype(_U32)
        kb = _sat0_u32(k - np.uint32(32))
        ka = k - kb
        hi_out = _shr32(self.hi, ka)
        within_lo = _shr32(self.lo, ka) | _shl32(self.hi, np.uint32(32) - ka)
        cross_lo = _shr32(self.hi, kb)
        m = (((np.uint32(32) - k) >> np.uint32(31)) - np.uint32(1))
        return SplitWord((within_lo & m) | (cross_lo & ~m), hi_out & m)

    # -- niceties -------------------------------------------------------------
    @property
    def shape(self):
        return jnp.broadcast_shapes(self.lo.shape, self.hi.shape)

    def __repr__(self):
        return f"SplitWord(lo={self.lo!r}, hi={self.hi!r})"


class SplitView:
    """A :class:`PackedLayout` view that materializes mask constants as
    :class:`SplitWord` pairs, letting ``word.py`` formulas run on split
    operands.

    ``word_dtype`` reads as u32 so the scalar side-computations of the shift
    ops (shift-amount clamps, per-width keep-bit counts -- all values < 64)
    stay in native u32; ``word_bits`` stays 64 so amount clamping and the
    exceed-width guard (pint.hpp:1011-1013) see the true word width.
    """

    is_split = True
    word_dtype = _U32

    def __init__(self, layout: PackedLayout):
        if layout.word_bits != 64:
            raise ValueError(f"SplitView is for u64 layouts, got {layout}")
        self._layout = layout

    def make_const(self, value: int) -> SplitWord:
        return SplitWord.const(value & self._layout.word_ones)

    def __getattr__(self, name):
        return getattr(self._layout, name)

    def __hash__(self):
        return hash(("split", self._layout))

    def __eq__(self, other):
        return (
            isinstance(other, SplitView) and self._layout == other._layout
        )

    def __repr__(self):
        return f"SplitView({self._layout!r})"


def split_u64(x: Array) -> SplitWord:
    """Bitcast a uint64 array into its u32 halves (requires x64)."""
    pair = jax.lax.bitcast_convert_type(x, _U32)  # (..., 2), little-endian
    return SplitWord(pair[..., 0], pair[..., 1])


def merge_u64(w: SplitWord) -> Array:
    """Recombine u32 halves into a uint64 array (requires x64)."""
    pair = jnp.stack(
        [jnp.broadcast_to(w.lo, w.shape), jnp.broadcast_to(w.hi, w.shape)],
        axis=-1,
    )
    return jax.lax.bitcast_convert_type(pair, np.dtype("uint64"))
