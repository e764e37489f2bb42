"""Randomized property tests: every op x many layouts vs the per-lane oracle.

The reference relies on hand-picked boundary cases; here random whole-word
inputs sweep lane widths 1..11 (and mixed), all four word sizes, and all
three saturation-mask strategies, checking bit-exact agreement with the
independent numpy per-lane implementation (pint_jax.utils.oracle).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax import PackedArray, PackedLayout
from pint_jax.ops import word as W
from pint_jax.utils import Oracle

LAYOUTS = [
    PackedLayout(1),
    PackedLayout(8),
    PackedLayout(1, 1, 1),
    PackedLayout(3, 3, 3),
    PackedLayout(5, 6, 5),
    PackedLayout(3, 4, 3),
    PackedLayout(4, 6, 4),
    PackedLayout(3, 7, 6),
    PackedLayout(1, 3, 5, 11),
    PackedLayout(1, 2, 3, 4, 5, 6, 11),   # reference flagship hetero config
    PackedLayout(8, 8, 8, 8),             # reference SIMD-comparison config
    PackedLayout(2, 2, 5, 2, 5),          # repeated hetero widths (type 2)
    PackedLayout(16, 16),
    PackedLayout(32),
    PackedLayout(11, 11, 10),
    PackedLayout(*([8] * 8)),             # uint64 words (pint_bench Pint64)
    PackedLayout(64),
    PackedLayout(7, 9, 13, 21),
]

BINOPS = [
    "add_wrap",
    "sub_wrap",
    "add_unsigned_saturate",
    "sub_unsigned_saturate",
    "add_signed_saturate",
    "sub_signed_saturate",
    "min_unsigned",
    "max_unsigned",
    "min_signed",
    "max_signed",
]


def _random_words(layout, n, seed):
    """Random canonical words: unused high bits zero.

    Matches the reference's de-facto invariant -- every packed_int value is
    produced by make_truncate (pint.hpp:592-601), which never sets bits above
    sum(widths).  Ops preserve canonicality, so it is the API contract.
    """
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << layout.word_bits, size=(n,), dtype=np.uint64)
    return words & np.uint64(layout.used_mask)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", BINOPS)
def test_binop_matches_oracle(layout, opname):
    n = 512
    aw = _random_words(layout, n, seed=hash((layout.widths, opname, 0)) % 2**31)
    bw = _random_words(layout, n, seed=hash((layout.widths, opname, 1)) % 2**31)
    oracle = Oracle(layout)
    expected = getattr(oracle, opname)(aw, bw)

    a = jnp.asarray(aw.astype(layout.word_dtype))
    b = jnp.asarray(bw.astype(layout.word_dtype))
    got = getattr(W, opname)(layout, a, b)
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.uint64),
        expected & np.uint64(layout.word_ones),
        err_msg=f"{opname} on {layout}",
    )


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", ["shift_left", "shift_right_unsigned"])
def test_shift_matches_oracle(layout, opname):
    n = 256
    vw = _random_words(layout, n, seed=hash((layout.widths, opname)) % 2**31)
    oracle = Oracle(layout)
    v = jnp.asarray(vw.astype(layout.word_dtype))
    for amount in list(range(0, layout.max_width + 2)) + [63, 200]:
        expected = getattr(oracle, opname)(vw, amount)
        got = getattr(W, opname)(layout, v, amount)
        np.testing.assert_array_equal(
            np.asarray(got).astype(np.uint64),
            expected & np.uint64(layout.word_ones),
            err_msg=f"{opname}({amount}) on {layout}",
        )
        # traced amount must agree with the static path
        got_traced = getattr(W, opname)(layout, v, jnp.uint32(amount))
        np.testing.assert_array_equal(
            np.asarray(got_traced), np.asarray(got),
            err_msg=f"traced {opname}({amount}) on {layout}",
        )


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_pack_unpack_roundtrip(layout):
    n = 256
    vw = _random_words(layout, n, seed=42)
    oracle = Oracle(layout)
    v = jnp.asarray(vw.astype(layout.word_dtype))
    # unpack -> pack is identity on the used bits
    lanes = W.unpack(layout, v)
    np.testing.assert_array_equal(
        np.asarray(W.pack(layout, lanes)).astype(np.uint64),
        vw & np.uint64(layout.used_mask),
    )
    # unsigned lanes match oracle
    np.testing.assert_array_equal(
        np.asarray(lanes).astype(np.int64), oracle.unpack(vw)
    )
    # signed lanes match oracle
    np.testing.assert_array_equal(
        np.asarray(W.unpack_signed(layout, v)).astype(np.int64),
        oracle.unpack_signed(vw),
    )


@pytest.mark.parametrize(
    "layout",
    [PackedLayout(1, 2, 3, 4, 5, 6, 11), PackedLayout(3, 7, 6)],
    ids=str,
)
def test_slice_random(layout):
    vw = _random_words(layout, 64, seed=7)
    v = jnp.asarray(vw.astype(layout.word_dtype))
    oracle = Oracle(layout)
    all_lanes = oracle.unpack(vw)
    for start in range(layout.num_lanes):
        for end in range(start + 1, layout.num_lanes + 1):
            sub, word = W.slice_word(layout, v, start, end)
            sub_oracle = Oracle(sub)
            np.testing.assert_array_equal(
                sub_oracle.unpack(np.asarray(word).astype(np.uint64)),
                all_lanes[..., start:end],
            )


@pytest.mark.parametrize(
    "layout",
    [PackedLayout(3, 3, 3), PackedLayout(1, 2, 3, 4, 5, 6, 11),
     PackedLayout(5, 6, 5), PackedLayout(1)],
    ids=str,
)
def test_ops_preserve_canonical_words(layout):
    """The API contract: canonical in (unused high bits zero) -> canonical
    out, for every op.  This is what makes op chaining sound."""
    aw = _random_words(layout, 256, seed=11)
    bw = _random_words(layout, 256, seed=12)
    a = jnp.asarray(aw.astype(layout.word_dtype))
    b = jnp.asarray(bw.astype(layout.word_dtype))
    unused = ~np.uint64(layout.used_mask)
    for opname in BINOPS:
        out = np.asarray(getattr(W, opname)(layout, a, b)).astype(np.uint64)
        assert not (out & unused).any(), f"{opname} set unused bits"
    for opname in ("shift_left", "shift_right_unsigned"):
        for amount in (0, 1, layout.max_width - 1):
            out = np.asarray(
                getattr(W, opname)(layout, a, amount)
            ).astype(np.uint64)
            assert not (out & unused).any(), f"{opname}({amount})"


def test_packed_array_pytree():
    import jax

    lay = PackedLayout(8, 8, 8, 8)
    p = PackedArray.from_words(lay, jnp.arange(8, dtype=jnp.uint32))
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 1
    p2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert p2.layout == lay
