"""Branch-free SWAR lane arithmetic on word tensors (jnp reference path).

This is the L2/L3 layer of SURVEY.md: every public operation of the reference
library (pint.hpp:758-1031) expressed as a pure function on unsigned JAX
arrays, parameterized by a :class:`~pint_jax.layout.PackedLayout`.  The
formulas are the whole-word bit-trick identities of the reference -- kept
compare-free on purpose (the device executes them as straight-line int32 vector
ops; XLA fuses whole chains into one elementwise loop over HBM tiles):

  add_wrap              pint.hpp:826-838
  carry_add_vector      pint.hpp:375-378
  carry_sub_vector      pint.hpp:380-383
  overflow_signed_sub   pint.hpp:385-388
  unsigned saturation   pint.hpp:409-558
  signed saturation     pint.hpp:560-590
  sub_wrap              pint.hpp:870-884
  sub_*_saturate        pint.hpp:886-919
  min/max (un)signed    pint.hpp:936-1004
  lane shifts           pint.hpp:610-705, 1006-1029
  get/get_signed/slice  pint.hpp:799-822, 923-932
  pack (make_truncate)  pint.hpp:390-407, 592-601

All functions operate elementwise on arrays of any shape whose dtype is the
layout's word dtype; Python-int mask constants fold into the compiled program.
Shift amounts may be Python ints or traced scalars -- the exceed-width guard
stays branch-free (pint.hpp:1011-1013), so there is no data-dependent control
flow anywhere.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.layout import PackedLayout

Array = jax.Array
Amount = Union[int, Array]

__all__ = [
    "pack",
    "unpack",
    "unpack_signed",
    "get",
    "get_signed",
    "slice_word",
    "add_wrap",
    "add_unsigned_saturate",
    "add_signed_saturate",
    "sub_wrap",
    "sub_unsigned_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
    "shift_left",
    "shift_right_unsigned",
]


def _check_x64(layout: PackedLayout) -> None:
    if layout.word_bits == 64 and not jax.config.jax_enable_x64:
        raise RuntimeError(
            "64-bit packed words need jax_enable_x64 "
            "(jax.config.update('jax_enable_x64', True)); without it JAX "
            "silently truncates uint64 to uint32"
        )


def _k(layout: PackedLayout, value: int) -> Array:
    """A mask constant in the layout's word dtype.

    A layout exposing ``make_const`` (the u64-as-2xu32
    :class:`~pint_jax.ops.split64.SplitView`) materializes the constant in
    its own word representation instead; every formula below then evaluates
    unchanged on split operands.
    """
    make = getattr(layout, "make_const", None)
    if make is not None:
        return make(value)
    _check_x64(layout)
    return jnp.asarray(value & layout.word_ones, dtype=layout.word_dtype)


def _as_word(layout: PackedLayout, x) -> Array:
    _check_x64(layout)
    x = jnp.asarray(x)
    if x.dtype != layout.word_dtype:
        # bit-pattern reinterpretation for the matching signed type, value
        # conversion otherwise
        if x.dtype == layout.signed_dtype:
            x = jax.lax.bitcast_convert_type(x, layout.word_dtype)
        else:
            x = x.astype(layout.word_dtype)
    return x


# ---------------------------------------------------------------------------
# pack / unpack / lane access
# ---------------------------------------------------------------------------


def pack(layout: PackedLayout, *lanes) -> Array:
    """Pack per-lane arrays into words, truncating each lane to its width.

    Array form of the truncating constructor ``make_truncate``
    (pint.hpp:592-601): OR of ``(lane_i & ones_i) << offset_i``.  Accepts one
    array per lane (broadcastable shapes) or a single stacked array whose
    last axis is the lane axis.
    """
    if len(lanes) == 1 and not isinstance(lanes[0], (list, tuple)):
        stacked = jnp.asarray(lanes[0])
        if stacked.shape and stacked.shape[-1] == layout.num_lanes:
            lanes = tuple(stacked[..., i] for i in range(layout.num_lanes))
    if len(lanes) != layout.num_lanes:
        raise ValueError(
            f"expected {layout.num_lanes} lane arrays, got {len(lanes)}"
        )
    word = None
    for lane, ones, off in zip(lanes, layout.lane_ones, layout.offsets):
        v = _as_word(layout, lane) & _k(layout, ones)
        v = v << np.array(off, layout.word_dtype) if off else v
        word = v if word is None else word | v
    return word


def get(layout: PackedLayout, word: Array, index: int) -> Array:
    """Extract lane ``index`` zero-extended (pint.hpp:799-807)."""
    off = layout.offsets[index]
    v = word >> np.array(off, layout.word_dtype) if off else word
    return v & _k(layout, layout.lane_ones[index])


def get_signed(layout: PackedLayout, word: Array, index: int) -> Array:
    """Extract lane ``index`` sign-extended, as the signed word dtype.

    Shift the lane's top bit to the word's sign position, then arithmetic
    shift back (pint.hpp:809-822).
    """
    off, w = layout.offsets[index], layout.widths[index]
    wb = layout.word_bits
    up = wb - (off + w)
    shifted = word << np.array(up, layout.word_dtype) if up else word
    signed = jax.lax.bitcast_convert_type(shifted, layout.signed_dtype)
    return jax.lax.shift_right_arithmetic(
        signed, np.array(wb - w, layout.signed_dtype)
    )


def unpack(layout: PackedLayout, word: Array) -> Array:
    """All lanes zero-extended, stacked on a new trailing axis."""
    return jnp.stack(
        [get(layout, word, i) for i in range(layout.num_lanes)], axis=-1
    )


def unpack_signed(layout: PackedLayout, word: Array) -> Array:
    """All lanes sign-extended, stacked on a new trailing axis."""
    return jnp.stack(
        [get_signed(layout, word, i) for i in range(layout.num_lanes)], axis=-1
    )


def slice_word(
    layout: PackedLayout,
    word: Array,
    start: int,
    end: int,
    *,
    keep_word_dtype: bool = False,
):
    """Extract lanes [start, end) as a new packed word (pint.hpp:923-932).

    Returns ``(sub_layout, sub_word)``; the sub-word is re-based to bit 0.
    By default it is cast to the sub-layout's natural word dtype
    (narrower streams); ``keep_word_dtype=True``
    reproduces the reference exactly, whose ``sliced_int`` keeps the
    parent's Integer type (pint.hpp:746-754).
    """
    sub = layout.slice(start, end)
    lo_bits = sum(layout.widths[:start])
    mid_bits = sum(layout.widths[start:end])
    v = word >> np.array(lo_bits, layout.word_dtype) if lo_bits else word
    v = v & _k(layout, (1 << mid_bits) - 1)
    return sub, (v if keep_word_dtype else v.astype(sub.word_dtype))


# ---------------------------------------------------------------------------
# carry / borrow / overflow bit vectors
# ---------------------------------------------------------------------------


def _carry_add_vector(a: Array, b: Array) -> Array:
    """Bit k set iff adding a+b produces a carry OUT of bit k
    (pint.hpp:375-378)."""
    return (a & b) | ((a | b) & ~(a + b))


def _carry_sub_vector(a: Array, b: Array) -> Array:
    """Bit k set iff a-b borrows out of bit k (pint.hpp:380-383)."""
    return (~a & b) | (~(a ^ b) & (a - b))


def _overflow_signed_sub_vector(a: Array, b: Array, res: Array) -> Array:
    """Signed-overflow bits of a-b=res (pint.hpp:385-388)."""
    return (~a & b & res) | (a & ~(b | res))


# ---------------------------------------------------------------------------
# saturation-mask machinery
# ---------------------------------------------------------------------------


def _dispatch_mask(layout: PackedLayout, carries: Array) -> Array:
    """Place a 1 at the LSB of every lane whose hi-order carry bit is set.

    Strategy-selected OR of shifted copies (pint.hpp:443-542); the selection
    happened at layout-construction time (PackedLayout.sat_terms).
    """
    acc = None
    for shift, mask in layout.sat_terms:
        t = carries >> np.array(shift, layout.word_dtype) if shift else carries
        if mask is not None:
            t = t & _k(layout, mask)
        acc = t if acc is None else acc | t
    if layout.sat_final_mask is not None:
        acc = acc & _k(layout, layout.sat_final_mask)
    return acc


def _smear(layout: PackedLayout, carries: Array) -> Array:
    """Expand per-lane hi-order carry bits into all-ones lane masks:
    ``(c << 1) - dispatch(c)`` (pint.hpp:544-551)."""
    return (carries << np.array(1, layout.word_dtype)) - _dispatch_mask(
        layout, carries
    )


def _signed_sat_mask(layout: PackedLayout, overflow: Array) -> Array:
    """0111... pattern over each overflowed lane: ``ovf - dispatch(ovf)``
    (pint.hpp:563-567)."""
    return overflow - _dispatch_mask(layout, overflow)


def _apply_signed_saturation(
    layout: PackedLayout, total: Array, overflow: Array
) -> Array:
    """Clamp overflowed lanes to INT_MAX/INT_MIN patterns
    (pint.hpp:569-574)."""
    m1 = _signed_sat_mask(layout, overflow)
    m2 = _signed_sat_mask(layout, overflow & ~total)
    return ((total ^ overflow) | m1) ^ m2


# ---------------------------------------------------------------------------
# add / sub
# ---------------------------------------------------------------------------


def add_wrap(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane modular add, carries confined to lanes (pint.hpp:826-838)."""
    m2 = _k(layout, layout.hi_mask)
    m1 = _k(layout, layout.body_mask)
    return ((a & m1) + (b & m1)) ^ ((a ^ b) & m2)


def add_unsigned_saturate(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane unsigned add, overflowed lanes clamp to all-ones
    (pint.hpp:840-855)."""
    m2 = _k(layout, layout.hi_mask)
    wrapped = add_wrap(layout, a, b)
    carries = _carry_add_vector(a, b) & m2
    return wrapped | _smear(layout, carries)


def add_signed_saturate(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane signed add; overflow clamps to lane INT_MAX / INT_MIN
    (pint.hpp:857-866, 576-582)."""
    m2 = _k(layout, layout.hi_mask)
    wrapped = add_wrap(layout, a, b)
    overflow = ~(a ^ b) & (wrapped ^ b) & m2
    return _apply_signed_saturation(layout, wrapped, overflow)


def sub_wrap(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane modular subtract via a + ~b + 1-per-lane
    (pint.hpp:870-884)."""
    m3 = _k(layout, layout.lo_mask)
    m2 = _k(layout, layout.hi_mask)
    m1 = _k(layout, layout.body_mask)
    nb = ~b
    return (
        ((a & m1) + (nb & m1) + (m3 & m1))
        ^ ((a ^ nb) & m2)
        ^ (m2 & m3)
    )


def sub_unsigned_saturate(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane unsigned subtract, clamping to zero on borrow
    (pint.hpp:886-908): unsigned-saturate ``a + ~b`` against the borrow
    vector, then add 1 per lane."""
    m2 = _k(layout, layout.hi_mask)
    m3 = _k(layout, layout.lo_mask)
    partial = add_wrap(layout, a, ~b)
    borrows = _carry_sub_vector(a, b) & m2
    saturated = partial | _smear(layout, borrows)
    return add_wrap(layout, saturated, m3)


def sub_signed_saturate(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane signed subtract with INT_MAX/INT_MIN clamping
    (pint.hpp:910-919, 584-590)."""
    m2 = _k(layout, layout.hi_mask)
    diff = sub_wrap(layout, a, b)
    overflow = _overflow_signed_sub_vector(a, b, diff) & m2
    return _apply_signed_saturation(layout, diff, overflow)


# ---------------------------------------------------------------------------
# min / max
# ---------------------------------------------------------------------------


def _interleave(a: Array, b: Array, mask: Array) -> Array:
    """Per-bit select: mask ? a : b (pint.hpp:603-606)."""
    return (a & mask) | (b & ~mask)


def min_unsigned(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane unsigned min via borrow-smear select (pint.hpp:936-950)."""
    m2 = _k(layout, layout.hi_mask)
    lt = _smear(layout, _carry_sub_vector(a, b) & m2)  # lanes where a < b
    return _interleave(a, b, lt)


def max_unsigned(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane unsigned max (pint.hpp:952-966)."""
    m2 = _k(layout, layout.hi_mask)
    gt = _smear(layout, _carry_sub_vector(b, a) & m2)  # lanes where a > b
    return _interleave(a, b, gt)


def min_signed(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane signed min: bias-flip sign bits, compare unsigned
    (pint.hpp:968-985)."""
    m2 = _k(layout, layout.hi_mask)
    lt = _smear(layout, _carry_sub_vector(a ^ m2, b ^ m2) & m2)
    return _interleave(a, b, lt)


def max_signed(layout: PackedLayout, a: Array, b: Array) -> Array:
    """Per-lane signed max (pint.hpp:987-1004)."""
    m2 = _k(layout, layout.hi_mask)
    gt = _smear(layout, _carry_sub_vector(b ^ m2, a ^ m2) & m2)
    return _interleave(a, b, gt)


# ---------------------------------------------------------------------------
# lane shifts (runtime amounts, branch-free)
# ---------------------------------------------------------------------------


def _amount(layout: PackedLayout, amount: Amount) -> tuple[Array, Array]:
    """Normalize a shift amount.

    Returns ``(amt, guard)``: ``amt`` clamped to [0, word_bits] in the word
    dtype (so truncating to a narrow word cannot alias a huge amount into
    range), and ``guard`` = all-ones iff the *untruncated* amount is below
    the widest lane (pint.hpp:1011-1013), else 0.
    """
    a = jnp.asarray(amount)
    if not jnp.issubdtype(a.dtype, jnp.integer):
        raise TypeError(f"shift amount must be integral, got {a.dtype}")
    a32 = a.astype(jnp.uint32)
    diff = np.uint32(layout.max_width) - a32 - np.uint32(1)
    sign = diff >> np.uint32(31)  # 0 or 1
    # subtract AFTER casting so all-ones spans the full word width
    guard = sign.astype(layout.word_dtype) - np.array(1, layout.word_dtype)
    amt = jnp.minimum(a32, np.uint32(layout.word_bits)).astype(layout.word_dtype)
    return amt, guard


def _shl_full(x: Array, k: Array) -> Array:
    """Left shift with exact mod-2^w semantics for k in [0, word_bits].

    XLA leaves shifts >= bit width undefined; splitting into two shifts keeps
    k == word_bits exact (result 0) without a branch.  Split words carry
    their own exact [0, 64] shift (cross-half, branch-free).
    """
    if hasattr(x, "shl_full"):
        return x.shl_full(k)
    wb = x.dtype.itemsize * 8
    k1 = jnp.minimum(k, np.array(wb - 1, x.dtype))
    return (x << k1) << (k - k1)


def _shr_full(x: Array, k: Array) -> Array:
    if hasattr(x, "shr_full"):
        return x.shr_full(k)
    wb = x.dtype.itemsize * 8
    k1 = jnp.minimum(k, np.array(wb - 1, x.dtype))
    return (x >> k1) >> (k - k1)


def _sat_to_zero(x: Array) -> Array:
    """0 if the word's sign bit is set, else x (pint.hpp:616-620)."""
    wb = x.dtype.itemsize * 8
    sign = x >> np.array(wb - 1, x.dtype)
    return (sign - np.array(1, x.dtype)) & x


def shift_left(layout: PackedLayout, word: Array, amount: Amount) -> Array:
    """Per-lane left shift by a (possibly traced) scalar amount
    (pint.hpp:1006-1017).

    Pre-clears the top ``amount`` bits of every lane so cross-lane bleed is
    impossible, then performs one whole-word shift.  Lanes narrower than the
    amount zero out; the whole result zeroes when ``amount >= max(widths)``
    via the branch-free guard.
    """
    amt, guard = _amount(layout, amount)
    lo = _k(layout, layout.lo_mask)
    if layout.all_same:
        # keep low (B0 - amount) bits of each lane (pint.hpp:661-668)
        keep_bits = _sat_to_zero(np.array(layout.widths[0], layout.word_dtype) - amt)
        keep = _shl_full(lo, keep_bits) - lo
    else:
        # per-width mask collection (pint.hpp:630-658); word ^ word is a
        # representation-agnostic zero (works for split words too)
        keep = word ^ word
        for w, mask_w in layout.width_groups:
            mw = _k(layout, mask_w)
            kb = _sat_to_zero(np.array(w, layout.word_dtype) - amt)
            keep = keep | (_shl_full(mw, kb) - mw)
    return guard & _shl_full(keep & word, amt)


def shift_right_unsigned(
    layout: PackedLayout, word: Array, amount: Amount
) -> Array:
    """Per-lane logical right shift by a runtime amount
    (pint.hpp:1019-1029): clear the bottom ``min(width, amount)`` bits of
    each lane, then one whole-word shift."""
    amt, guard = _amount(layout, amount)
    lo = _k(layout, layout.lo_mask)
    if layout.all_same:
        # (pint.hpp:698-705)
        clear = _shl_full(lo, amt) - lo
    else:
        # (pint.hpp:670-695); min(width, amount) is branch-free find_min
        clear = word ^ word
        for w, mask_w in layout.width_groups:
            mw = _k(layout, mask_w)
            wv = np.array(w, layout.word_dtype)
            kmin = wv - _sat_to_zero(wv - amt)
            clear = clear | (_shl_full(mw, kmin) - mw)
    return guard & _shr_full(~clear & word, amt)
