"""Layout-construction tests.

JAX equivalent of the reference's compile-time checks: the word-dtype
boundary table (pint_test.cpp:58-87 static_asserts), mask derivation, and the
saturation-strategy selection (pint.hpp:443-456).
"""

import numpy as np
import pytest

from pint_jax import PackedLayout, word_bits_for


# word-size boundaries, matching pint_test.cpp:58-87
@pytest.mark.parametrize(
    "total,expected",
    [
        (1, 8), (7, 8), (8, 8),
        (9, 16), (15, 16), (16, 16),
        (17, 32), (31, 32), (32, 32),
        (33, 64), (63, 64), (64, 64),
    ],
)
def test_word_bits_boundaries(total, expected):
    assert word_bits_for(total) == expected


def test_word_dtype_selection():
    assert PackedLayout(5, 6, 5).word_dtype == np.dtype(np.uint16)
    assert PackedLayout(3, 3, 3).word_dtype == np.dtype(np.uint16)
    assert PackedLayout(1, 1, 1).word_dtype == np.dtype(np.uint8)
    assert PackedLayout(1, 2, 3, 4, 5, 6, 11).word_dtype == np.dtype(np.uint32)
    assert PackedLayout(8, 8, 8, 8).word_dtype == np.dtype(np.uint32)
    assert PackedLayout(*([8] * 8)).word_dtype == np.dtype(np.uint64)


def test_too_wide_rejected():
    with pytest.raises(ValueError):
        PackedLayout(*([8] * 9))
    with pytest.raises(ValueError):
        word_bits_for(65)


def test_bad_widths_rejected():
    with pytest.raises(ValueError):
        PackedLayout()
    with pytest.raises(ValueError):
        PackedLayout(0, 3)
    with pytest.raises(ValueError):
        PackedLayout(-1)


def test_offsets_and_masks_565():
    lay = PackedLayout(5, 6, 5)
    assert lay.offsets == (0, 5, 11)
    assert lay.total_bits == 16
    # hi bits at 4, 10, 15; lo bits at 0, 5, 11
    assert lay.hi_mask == (1 << 4) | (1 << 10) | (1 << 15)
    assert lay.lo_mask == (1 << 0) | (1 << 5) | (1 << 11)
    assert lay.used_mask == 0xFFFF
    assert lay.body_mask == 0xFFFF & ~lay.hi_mask
    assert lay.lane_ones == (0x1F, 0x3F, 0x1F)
    assert lay.field_masks == (0x1F, 0x3F << 5, 0x1F << 11)


def test_sat_type_detection():
    # all widths equal -> type 0 (pint.hpp:459-464)
    assert PackedLayout(3, 3, 3).sat_type == 0
    assert PackedLayout(8, 8, 8, 8).sat_type == 0
    # distinct widths, non-colliding shifted hi bits -> type 1
    assert PackedLayout(5, 6, 5).sat_type in (1, 2)
    # the reference's flagship hetero config exercises type 2 machinery
    lay = PackedLayout(1, 2, 3, 4, 5, 6, 11)
    assert lay.sat_type in (1, 2)
    # the dispatch must put exactly one bit at each lane LSB: verified by
    # simulating on every single-lane carry pattern
    for test_lay in [
        PackedLayout(3, 3, 3),
        PackedLayout(5, 6, 5),
        PackedLayout(3, 4, 3),
        PackedLayout(1, 2, 3, 4, 5, 6, 11),
        PackedLayout(1, 3, 5, 11),
        PackedLayout(4, 6, 4),
        PackedLayout(1, 1, 1),
        PackedLayout(3, 7, 6),
        PackedLayout(2, 2, 5, 2, 5),  # repeated heterogeneous widths
    ]:
        for i, (off, w) in enumerate(zip(test_lay.offsets, test_lay.widths)):
            carry = 1 << (off + w - 1)
            acc = 0
            for shift, mask in test_lay.sat_terms:
                t = carry >> shift
                if mask is not None:
                    t &= mask
                acc |= t
            if test_lay.sat_final_mask is not None:
                acc &= test_lay.sat_final_mask
            assert acc == (1 << off), (test_lay, i)


def test_slice_layout():
    lay = PackedLayout(1, 2, 3, 4, 5)
    sub = lay.slice(2, 4)
    assert sub.widths == (3, 4)
    with pytest.raises(ValueError):
        lay.slice(3, 3)
    with pytest.raises(ValueError):
        lay.slice(0, 6)


def test_hashable_and_eq():
    assert PackedLayout(5, 6, 5) == PackedLayout(5, 6, 5)
    assert hash(PackedLayout(5, 6, 5)) == hash(PackedLayout(5, 6, 5))
    assert PackedLayout(5, 6, 5) != PackedLayout(5, 6, 6)
    d = {PackedLayout(8, 8): "x"}
    assert d[PackedLayout(8, 8)] == "x"
