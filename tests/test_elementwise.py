"""Parity tests: the jitted elementwise entry points vs the word.py
formulas called directly.  Bit-exact agreement is required for every op,
layout and array shape.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax import PackedLayout
from pint_jax.ops import elementwise as P
from pint_jax.ops import word as W

LAYOUTS = [
    PackedLayout(8, 8, 8, 8),
    PackedLayout(1, 2, 3, 4, 5, 6, 11),
    PackedLayout(5, 6, 5),          # u16 words
    PackedLayout(3, 3),             # u8 words
]


def _rand(layout, shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << layout.word_bits, size=shape, dtype=np.uint64)
    return jnp.asarray(
        (w & np.uint64(layout.used_mask)).astype(layout.word_dtype)
    )


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", P.BINOP_NAMES)
def test_binop_parity(layout, opname):
    a = _rand(layout, (1000,), 0)
    b = _rand(layout, (1000,), 1)
    expected = getattr(W, opname)(layout, a, b)
    got = P.binop(layout, opname)(a, b)
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))


@pytest.mark.parametrize("layout", LAYOUTS[:2], ids=str)
@pytest.mark.parametrize("opname", P.SHIFT_NAMES)
@pytest.mark.parametrize("amount", [0, 1, 3, 7, 12, 100])
def test_shift_parity(layout, opname, amount):
    v = _rand(layout, (777,), 2)
    expected = getattr(W, opname)(layout, v, amount)
    got = P.shift(layout, opname)(v, amount)
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))


@pytest.mark.parametrize("layout", LAYOUTS[:2], ids=str)
def test_2d_shapes(layout):
    a = _rand(layout, (33, 70), 3)
    b = _rand(layout, (33, 70), 4)
    expected = W.add_unsigned_saturate(layout, a, b)
    got = P.binop(layout, "add_unsigned_saturate")(a, b)
    assert got.shape == expected.shape
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))


def test_u64_two_tier():
    """u64 layouts: P.binop takes uint64 words, P.binop_pair the same
    words as planar u32 pairs -- tests/test_split64.py has the full pair
    parity matrix."""
    layout = PackedLayout(*([8] * 8))
    assert P.supported(layout)
    a = _rand(layout, (64,), 5)
    b = _rand(layout, (64,), 6)
    expected = W.add_unsigned_saturate(layout, a, b)
    got = P.binop(layout, "add_unsigned_saturate")(a, b)
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))
    pair = lambda w: jnp.asarray(
        np.stack(
            [
                np.asarray(w) & np.uint64(0xFFFFFFFF),
                np.asarray(w) >> np.uint64(32),
            ]
        ).astype(np.uint32)
    )
    got_k = np.asarray(
        P.binop_pair(layout, "add_unsigned_saturate")(pair(a), pair(b))
    )
    np.testing.assert_array_equal(np.asarray(pair(expected)), got_k)


@pytest.mark.parametrize("signed", [False, True])
def test_saturating_accumulate(signed):
    layout = PackedLayout(8, 8, 8, 8)
    steps = 4
    acc = _rand(layout, (500,), 7)
    deltas = jnp.stack([_rand(layout, (500,), 8 + s) for s in range(steps)])
    formula = W.add_signed_saturate if signed else W.add_unsigned_saturate
    expected = acc
    for s in range(steps):
        expected = formula(layout, expected, deltas[s])
    got = P.saturating_accumulate(layout, signed=signed, steps=steps)(
        acc, deltas
    )
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))
