"""Jitted entry points for the SWAR ops over whole word arrays.

Each entry point is one formula from :mod:`pint_jax.ops.word` (or a fixed
chain of them) under ``jax.jit``.  XLA fuses the formula into a single
elementwise loop that reads each operand once and writes the result once,
so a call is bound by memory bandwidth; no hand-written kernel is needed
to get there.

64-bit layouts have two entries.  :func:`binop`/:func:`shift` take uint64
words and need ``jax_enable_x64``.  :func:`binop_pair`/:func:`shift_pair`
take the same words as planar uint32 pairs -- ``pair[0]`` the low halves,
``pair[1]`` the high halves -- and evaluate the formulas over
:class:`~pint_jax.ops.split64.SplitWord` half-words, so they run with x64
off.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from pint_jax.layout import PackedLayout
from pint_jax.ops import split64 as S
from pint_jax.ops import word as W

Array = jax.Array

__all__ = [
    "supported",
    "binop",
    "binop_pair",
    "shift",
    "shift_pair",
    "saturating_accumulate",
    "BINOP_NAMES",
    "SHIFT_NAMES",
]

BINOP_NAMES = (
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
)
SHIFT_NAMES = ("shift_left", "shift_right_unsigned")


def supported(layout: PackedLayout) -> bool:
    """Whether the entry points cover this layout's word dtype (8, 16, 32
    and 64-bit words: always true for a valid layout)."""
    return layout.word_bits in (8, 16, 32, 64)


def _check_name(name: str, names) -> None:
    if name not in names:
        raise ValueError(f"unknown op {name!r}; expected one of {names}")


def _check_planar(pair: Array) -> None:
    """Planar pair words have the halves on the LEADING axis: (2, ...).
    A trailing pair axis would be silently misread (axis 0 becomes data),
    so reject anything whose first dim is not exactly 2."""
    if pair.ndim < 1 or pair.shape[0] != 2 or pair.dtype != jnp.uint32:
        raise ValueError(
            f"pair words must be planar uint32 (2, ...) -- [0]=low half, "
            f"[1]=high half; got shape {pair.shape} dtype {pair.dtype}"
        )


def _check_u64(layout: PackedLayout, entry: str) -> None:
    if layout.word_bits != 64:
        raise ValueError(f"{entry} is for u64 layouts, got {layout}")


@functools.lru_cache(maxsize=None)
def binop(layout: PackedLayout, name: str) -> Callable[[Array, Array], Array]:
    """A jitted binary SWAR op ``(words, words) -> words``."""
    _check_name(name, BINOP_NAMES)
    formula = getattr(W, name)
    return jax.jit(lambda a, b: formula(layout, a, b))


@functools.lru_cache(maxsize=None)
def shift(layout: PackedLayout, name: str) -> Callable[[Array, object], Array]:
    """A jitted lane shift ``(words, amount) -> words``; ``amount`` is a
    runtime scalar (the formula's branch-free guard zeroes lanes for
    amounts past the lane width)."""
    _check_name(name, SHIFT_NAMES)
    formula = getattr(W, name)
    return jax.jit(lambda v, amount: formula(layout, v, amount))


@functools.lru_cache(maxsize=None)
def binop_pair(
    layout: PackedLayout, name: str
) -> Callable[[Array, Array], Array]:
    """Binary SWAR op on u64 words carried as (2, ...) planar u32 pairs:
    the x64-free entry for 64-bit layouts."""
    _check_name(name, BINOP_NAMES)
    _check_u64(layout, "binop_pair")
    formula = getattr(W, name)
    view = S.SplitView(layout)

    @jax.jit
    def run(a: Array, b: Array) -> Array:
        _check_planar(a)
        _check_planar(b)
        out = formula(view, S.SplitWord(a[0], a[1]), S.SplitWord(b[0], b[1]))
        return jnp.stack([out.lo, out.hi])

    return run


@functools.lru_cache(maxsize=None)
def shift_pair(
    layout: PackedLayout, name: str
) -> Callable[[Array, object], Array]:
    """Lane shift on (2, ...) planar u32 pair words (x64-free u64)."""
    _check_name(name, SHIFT_NAMES)
    _check_u64(layout, "shift_pair")
    formula = getattr(W, name)
    view = S.SplitView(layout)

    @jax.jit
    def run(v: Array, amount) -> Array:
        _check_planar(v)
        out = formula(view, S.SplitWord(v[0], v[1]), amount)
        return jnp.stack([out.lo, out.hi])

    return run


@functools.lru_cache(maxsize=None)
def saturating_accumulate(
    layout: PackedLayout, *, signed: bool = True, steps: int = 1
) -> Callable[[Array, Array], Array]:
    """Multi-step saturating accumulate ``acc <- sat(acc + d_s)`` over
    ``steps`` delta planes (``deltas`` has shape ``(steps, *acc.shape)``).
    The chain fuses into one pass: ``2 + steps`` streams instead of the
    ``3 * steps`` of op-at-a-time execution."""
    formula = W.add_signed_saturate if signed else W.add_unsigned_saturate

    @jax.jit
    def run(acc: Array, deltas: Array) -> Array:
        for s in range(steps):
            acc = formula(layout, acc, deltas[s])
        return acc

    return run
