"""Native C++ SWAR library: parity vs the oracle and the jnp path."""

import numpy as np
import pytest

from pint_jax import PackedLayout
from pint_jax.native import BINOP_NAMES, SHIFT_NAMES, NativeOps, native_available
from pint_jax.utils import Oracle

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native toolchain unavailable"
)

LAYOUTS = [
    PackedLayout(8, 8, 8, 8),
    PackedLayout(1, 2, 3, 4, 5, 6, 11),
    PackedLayout(5, 6, 5),
    PackedLayout(3, 3),
    PackedLayout(*([8] * 8)),
    PackedLayout(64),
    PackedLayout(1),
]


def _rand(layout, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << layout.word_bits, size=n, dtype=np.uint64)
    return (w & np.uint64(layout.used_mask)).astype(layout.word_dtype)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", BINOP_NAMES)
def test_native_binop_matches_oracle(layout, opname):
    native = NativeOps(layout)
    oracle = Oracle(layout)
    a = _rand(layout, 512, 0)
    b = _rand(layout, 512, 1)
    got = getattr(native, opname)(a, b)
    expected = getattr(oracle, opname)(
        a.astype(np.uint64), b.astype(np.uint64)
    )
    np.testing.assert_array_equal(
        got.astype(np.uint64), expected & np.uint64(layout.word_ones)
    )


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", SHIFT_NAMES)
def test_native_shift_matches_oracle(layout, opname):
    native = NativeOps(layout)
    oracle = Oracle(layout)
    v = _rand(layout, 256, 2)
    for amount in range(0, layout.max_width + 2):
        got = getattr(native, opname)(v, amount)
        expected = getattr(oracle, opname)(v.astype(np.uint64), amount)
        np.testing.assert_array_equal(
            got.astype(np.uint64),
            expected & np.uint64(layout.word_ones),
            err_msg=f"{opname}({amount}) {layout}",
        )


def test_native_pack_unpack():
    layout = PackedLayout(8, 8, 8, 8)
    native = NativeOps(layout)
    rng = np.random.default_rng(3)
    lanes = rng.integers(-128, 128, size=(64, 4), dtype=np.int32)
    words = native.pack(lanes)
    back = native.unpack(words, signed=True)
    np.testing.assert_array_equal(back, lanes)
    uns = native.unpack(words, signed=False)
    np.testing.assert_array_equal(uns, lanes & 0xFF)


# pack/unpack at every word width (pint.hpp ctor/get span all Integer
# widths, pint.hpp:768-774, 799-822): differential vs the oracle's
# pack/get at u8/u16/u32/u64 incl. the u64 <8x8> bench config
PACK_LAYOUTS = [
    PackedLayout(3, 3),                 # u8
    PackedLayout(5, 6, 5),              # u16 (the README make_packed_int)
    PackedLayout(8, 8, 8, 8),           # u32
    PackedLayout(1, 2, 3, 4, 5, 6, 11), # u32 heterogeneous
    PackedLayout(*([8] * 8)),           # u64 <8x8> (pint_bench.cpp:468-485)
    PackedLayout(64),                   # u64 single full-width lane
]


@pytest.mark.parametrize("layout", PACK_LAYOUTS, ids=str)
def test_native_pack_unpack_all_widths(layout):
    native = NativeOps(layout)
    oracle = Oracle(layout)
    rng = np.random.default_rng(7)
    n = 128
    # random lane values spanning each lane's signed range, plus
    # out-of-range values exercising the truncating-ctor semantics
    lanes = np.stack(
        [
            rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
            for _ in layout.widths
        ],
        axis=-1,
    )
    words = native.pack(lanes)
    assert words.dtype == layout.word_dtype
    # oracle pack: truncate each lane then OR at offsets
    exp = np.zeros(n, dtype=np.uint64)
    for j, (w, off) in enumerate(zip(layout.widths, layout.offsets)):
        ones = np.uint64(~np.uint64(0)) if w >= 64 else np.uint64(
            (1 << w) - 1
        )
        exp |= (lanes[:, j].astype(np.uint64) & ones) << np.uint64(off)
    np.testing.assert_array_equal(words.astype(np.uint64), exp)

    # unsigned unpack == oracle get
    uns = native.unpack(words, signed=False)
    for j, (w, off) in enumerate(zip(layout.widths, layout.offsets)):
        ones = (1 << w) - 1 if w < 64 else (1 << 64) - 1
        expected = (words.astype(object) >> off) & ones
        np.testing.assert_array_equal(
            uns[:, j].astype(object) & ones, expected
        )

    # signed unpack: sign-extension round-trips in-range values
    in_range = np.stack(
        [
            rng.integers(
                -(1 << (w - 1)) if w > 1 else -1,
                (1 << (w - 1)) if w > 1 else 1,
                size=n,
                dtype=np.int64,
            )
            for w in layout.widths
        ],
        axis=-1,
    )
    back = native.unpack(native.pack(in_range), signed=True)
    np.testing.assert_array_equal(back, in_range)


def test_native_matches_jnp_path():
    import jax.numpy as jnp

    from pint_jax.ops import word as W

    layout = PackedLayout(1, 2, 3, 4, 5, 6, 11)
    native = NativeOps(layout)
    a = _rand(layout, 1024, 4)
    b = _rand(layout, 1024, 5)
    for op in ("add_unsigned_saturate", "sub_signed_saturate", "min_signed"):
        got = getattr(native, op)(a, b)
        exp = getattr(W, op)(layout, jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(got, np.asarray(exp))
