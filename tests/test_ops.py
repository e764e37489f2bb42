"""Unit tests for the public SWAR op surface.

Transliterates the semantics of the 61 reference GTest cases
(/root/reference/tests/pint_test.cpp) onto the PackedArray API: every case
taxonomy -- {no-overflow, overflow, boundary} x {equal, variable widths} x
{1-bit lanes} -- appears here with the same input/expected lane values.
Shift-amount cases use traced (jitted) amounts to force the runtime path,
the analog of the reference's ``volatile`` amounts (pint_test.cpp:666-670).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pint_jax as pt
from pint_jax import PackedArray, PackedLayout


def P(lay, *vals):
    return PackedArray.pack(lay, *[jnp.asarray(v) for v in vals])


def assert_packed_eq(expected: PackedArray, actual: PackedArray):
    assert expected.layout == actual.layout
    np.testing.assert_array_equal(
        np.asarray(expected.word), np.asarray(actual.word)
    )


# -- make_truncate (pint_test.cpp:89-107) -----------------------------------


def test_pack_without_overflow():
    lay = PackedLayout(5, 6, 5)
    r = P(lay, 1, 20, 10)
    assert int(r.word) == (1 | (20 << 5) | (10 << 11))


def test_pack_with_overflow():
    lay = PackedLayout(5, 6, 5)
    r = P(lay, 33, 66, 234)
    assert int(r.word) == ((33 & 0x1F) | ((66 & 0x3F) << 5) | ((234 & 0x1F) << 11))


# -- get / get_signed (pint_test.cpp:111-131) -------------------------------


def test_get_unsigned():
    lay = PackedLayout(5, 6, 5)
    r = P(lay, 1, 20, 10)
    assert int(pt.get(r, 0)) == 1
    assert int(pt.get(r, 1)) == 20
    assert int(pt.get(r, 2)) == 10


def test_get_signed():
    lay = PackedLayout(5, 6, 5)
    r = P(lay, 1, -3, -10)
    assert int(pt.get_signed(r, 0)) == 1
    assert int(pt.get_signed(r, 1)) == -3
    assert int(pt.get_signed(r, 2)) == -10
    assert int(pt.get(r, 1)) != -3


# -- slice (pint_test.cpp:135-146) ------------------------------------------


def test_slice():
    lay = PackedLayout(1, 2, 3, 4, 5)
    v = P(lay, 1, 2, 3, 4, 5)
    s = pt.slice_lanes(v, 2, 4)
    assert s.layout.widths == (3, 4)
    assert_packed_eq(P(PackedLayout(3, 4), 3, 4), s)


# -- add_wrap (pint_test.cpp:150-192) ---------------------------------------


def test_add_wrap_no_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, 1 + 3, 20 + 2, 10 + 1),
        pt.add_wrap(P(lay, 1, 20, 10), P(lay, 3, 2, 1)),
    )


def test_add_wrap_with_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, 31 + 1, 60 + 20, 10 + 27),
        pt.add_wrap(P(lay, 1, 60, 10), P(lay, 31, 20, 27)),
    )


def test_add_wrap_with_overflow2():
    lay = PackedLayout(3, 3, 3)
    assert_packed_eq(
        P(lay, 3 + 5, 4 + 6, 5 + 7),
        pt.add_wrap(P(lay, 3, 4, 5), P(lay, 5, 6, 7)),
    )


def test_add_wrap_1bit_packs():
    lay = PackedLayout(1, 1, 1)
    assert_packed_eq(
        P(lay, 1, 0, 0),
        pt.add_wrap(P(lay, 1, 0, 1), P(lay, 0, 0, 1)),
    )


# -- add_unsigned_saturate (pint_test.cpp:194-238) --------------------------


def test_addsat_u_equal_no_overflow():
    lay = PackedLayout(3, 3, 3)
    assert_packed_eq(
        P(lay, 3, 5, 7),
        pt.add_unsigned_saturate(P(lay, 1, 2, 3), P(lay, 2, 3, 4)),
    )


def test_addsat_u_equal_with_overflow():
    lay = PackedLayout(3, 3, 3)
    assert_packed_eq(
        P(lay, 7, 6, 7),
        pt.add_unsigned_saturate(P(lay, 1, 2, 3), P(lay, 7, 4, 6)),
    )


def test_addsat_u_equal_1bit_packs():
    lay = PackedLayout(1, 1, 1)
    assert_packed_eq(
        P(lay, 1, 0, 1),
        pt.add_unsigned_saturate(P(lay, 1, 0, 1), P(lay, 0, 0, 1)),
    )


def test_addsat_u_var_with_overflow():
    lay = PackedLayout(3, 4, 3)
    assert_packed_eq(
        P(lay, 7, 6, 7),
        pt.add_unsigned_saturate(P(lay, 1, 2, 3), P(lay, 7, 4, 6)),
    )


# -- add_signed_saturate (pint_test.cpp:242-352) ----------------------------


@pytest.mark.parametrize(
    "widths,a,b,expected",
    [
        # equal widths (4,4,4)
        ((4, 4, 4), (1, 2, 3), (2, 3, 4), (3, 5, 7)),
        ((4, 4, 4), (-1, -2, -3), (-2, -3, -4), (-3, -5, -7)),
        ((4, 4, 4), (1, -2, 3), (-2, 3, -4), (-1, 1, -1)),
        ((4, 4, 4), (1, 2, 3), (7, 4, 6), (7, 6, 7)),
        ((4, 4, 4), (-1, -2, -3), (-8, -4, -6), (-8, -6, -8)),
        # variable widths (4,5,4)
        ((4, 5, 4), (1, 2, 3), (2, 3, 4), (3, 5, 7)),
        ((4, 5, 4), (-1, -2, -3), (-2, -3, -4), (-3, -5, -7)),
        ((4, 5, 4), (1, -2, 3), (-2, 3, -4), (-1, 1, -1)),
        ((4, 5, 4), (1, 10, 3), (7, 14, 6), (7, 15, 7)),
        ((4, 5, 4), (-1, -12, -3), (-8, -14, -6), (-8, -16, -8)),
    ],
)
def test_addsat_s(widths, a, b, expected):
    lay = PackedLayout(*widths)
    assert_packed_eq(
        P(lay, *expected),
        pt.add_signed_saturate(P(lay, *a), P(lay, *b)),
    )


# -- sub_wrap (pint_test.cpp:356-409) ---------------------------------------


@pytest.mark.parametrize(
    "widths,a,b",
    [
        ((5, 6, 5), (4, 20, 10), (3, 2, 1)),
        ((3, 3, 3), (7, 6, 5), (1, 2, 3)),
        ((1, 1, 1), (1, 1, 0), (1, 0, 0)),
        ((3, 3, 3), (1, 4, 2), (7, 2, 6)),
        ((1, 1, 1), (1, 0, 0), (1, 1, 0)),
    ],
)
def test_sub_wrap(widths, a, b):
    lay = PackedLayout(*widths)
    expected = P(lay, *[x - y for x, y in zip(a, b)])
    assert_packed_eq(expected, pt.sub_wrap(P(lay, *a), P(lay, *b)))


# -- sub_unsigned_saturate (pint_test.cpp:413-444) --------------------------


def test_subsat_u_no_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, 1, 18, 9),
        pt.sub_unsigned_saturate(P(lay, 4, 20, 10), P(lay, 3, 2, 1)),
    )


def test_subsat_u_with_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, 1, 0, 0),
        pt.sub_unsigned_saturate(P(lay, 4, 2, 1), P(lay, 3, 20, 10)),
    )


def test_subsat_u_1bit_packs():
    lay = PackedLayout(1, 1, 1)
    assert_packed_eq(
        P(lay, 0, 0, 0),
        pt.sub_unsigned_saturate(P(lay, 1, 0, 0), P(lay, 1, 1, 0)),
    )


# -- sub_signed_saturate (pint_test.cpp:448-490) ----------------------------


def test_subsat_s_positive_no_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, 1, 18, 9),
        pt.sub_signed_saturate(P(lay, 4, 20, 10), P(lay, 3, 2, 1)),
    )


def test_subsat_s_negative_no_overflow():
    lay = PackedLayout(5, 6, 5)
    assert_packed_eq(
        P(lay, -1, -18, -9),
        pt.sub_signed_saturate(P(lay, -4, -20, -10), P(lay, -3, -2, -1)),
    )


def test_subsat_s_positive_negative_overflow():
    lay = PackedLayout(4, 6, 4)
    assert_packed_eq(
        P(lay, 7, 31, 6),
        pt.sub_signed_saturate(P(lay, 4, 0, 7), P(lay, -6, -32, 1)),
    )


def test_subsat_s_negative_positive_overflow():
    lay = PackedLayout(4, 6, 4)
    assert_packed_eq(
        P(lay, -8, -32, -7),
        pt.sub_signed_saturate(P(lay, -4, -2, -6), P(lay, 6, 30, 1)),
    )


# -- min/max unsigned (pint_test.cpp:494-558) -------------------------------


@pytest.mark.parametrize(
    "a,b,expected_min,expected_max",
    [
        ((1, 2, 3), (4, 5, 15), (1, 2, 3), (4, 5, 15)),
        ((4, 5, 15), (1, 2, 3), (1, 2, 3), (4, 5, 15)),
        ((4, 5, 3), (1, 15, 3), (1, 5, 3), (4, 15, 3)),
    ],
)
def test_minmax_unsigned(a, b, expected_min, expected_max):
    lay = PackedLayout(4, 6, 4)
    assert_packed_eq(P(lay, *expected_min), pt.min_unsigned(P(lay, *a), P(lay, *b)))
    assert_packed_eq(P(lay, *expected_max), pt.max_unsigned(P(lay, *a), P(lay, *b)))


# -- min/max signed (pint_test.cpp:562-626) ---------------------------------


@pytest.mark.parametrize(
    "a,b,expected_min,expected_max",
    [
        ((-1, -5, 0), (-4, -2, -8), (-4, -5, -8), (-1, -2, 0)),
        ((1, 5, 0), (4, 2, 7), (1, 2, 0), (4, 5, 7)),
        ((-1, 5, 0), (4, -2, 7), (-1, -2, 0), (4, 5, 7)),
    ],
)
def test_minmax_signed(a, b, expected_min, expected_max):
    lay = PackedLayout(4, 6, 4)
    assert_packed_eq(P(lay, *expected_min), pt.min_signed(P(lay, *a), P(lay, *b)))
    assert_packed_eq(P(lay, *expected_max), pt.max_signed(P(lay, *a), P(lay, *b)))


# -- shifts (pint_test.cpp:630-780) -----------------------------------------
# Traced amounts (via jit) stand in for the reference's volatile amounts.


def _traced_shift_left(v: PackedArray, amount: int) -> PackedArray:
    f = jax.jit(lambda p, a: pt.shift_left(p, a))
    return f(v, jnp.uint32(amount))


def _traced_shift_right(v: PackedArray, amount: int) -> PackedArray:
    f = jax.jit(lambda p, a: pt.shift_right_unsigned(p, a))
    return f(v, jnp.uint32(amount))


@pytest.mark.parametrize(
    "widths,value,amount,expected",
    [
        ((4, 4, 4), (1, 2, 3), 2, (4, 8, 12)),
        ((4, 4, 4), (1, 2, 3), 3, (8, 0, 8)),
        ((4, 4, 4), (1, 2, 3), 4, (0, 0, 0)),
        ((4, 4, 4), (1, 2, 3), 5, (0, 0, 0)),
        ((3, 7, 6), (1, 2, 3), 2, (4, 8, 12)),
        ((3, 7, 6), (1, 2, 3), 3, (0, 16, 24)),
        ((3, 7, 6), (1, 2, 3), 6, (0, 0, 0)),
    ],
)
def test_shift_left(widths, value, amount, expected):
    lay = PackedLayout(*widths)
    v = P(lay, *value)
    assert_packed_eq(P(lay, *expected), pt.shift_left(v, amount))
    assert_packed_eq(P(lay, *expected), _traced_shift_left(v, amount))


@pytest.mark.parametrize(
    "widths,value,amount,expected",
    [
        ((4, 4, 4), (4, 8, 12), 2, (1, 2, 3)),
        ((4, 4, 4), (4, 8, 12), 3, (0, 1, 1)),
        ((4, 4, 4), (4, 8, 12), 4, (0, 0, 0)),
        ((4, 4, 4), (4, 8, 12), 5, (0, 0, 0)),
        ((3, 7, 6), (4, 8, 12), 2, (1, 2, 3)),
        ((3, 7, 6), (5, 106, 42), 4, (0, 6, 2)),
        ((3, 7, 6), (5, 106, 42), 6, (0, 1, 0)),
    ],
)
def test_shift_right(widths, value, amount, expected):
    lay = PackedLayout(*widths)
    v = P(lay, *value)
    assert_packed_eq(P(lay, *expected), pt.shift_right_unsigned(v, amount))
    assert_packed_eq(P(lay, *expected), _traced_shift_right(v, amount))


# -- README worked examples as extra ground truth (README.md:149-217) -------


def test_readme_usage_example():
    # README.md:11-34: MyPack(2,10,20) + MyPack(1,2,12)
    lay = PackedLayout(5, 6, 5)
    a = P(lay, 2, 10, 20)
    b = P(lay, 1, 2, 12)
    assert_packed_eq(P(lay, 3, 12, 0), pt.add_wrap(a, b))
    assert_packed_eq(P(lay, 3, 12, 31), pt.add_unsigned_saturate(a, b))


def test_readme_add_wrap_example():
    lay = PackedLayout(5, 6, 5)
    a = P(lay, 1, 20, 10)
    b = P(lay, 30, 60, 20)
    assert_packed_eq(P(lay, 31, 80 - 64, 30), pt.add_wrap(a, b))


def test_readme_saturate_examples():
    lay = PackedLayout(5, 6, 5)
    a = P(lay, 1, 20, 10)
    b = P(lay, 31, 60, 20)
    assert_packed_eq(P(lay, 31, 63, 30), pt.add_unsigned_saturate(a, b))


# -- batched / vmapped semantics (array-native addition) --------------------


def test_batched_ops_match_scalar():
    lay = PackedLayout(1, 2, 3, 4, 5, 6, 11)
    rng = np.random.default_rng(0)
    aw = rng.integers(0, 2**32, size=(128,), dtype=np.uint32)
    bw = rng.integers(0, 2**32, size=(128,), dtype=np.uint32)
    a = PackedArray.from_words(lay, jnp.asarray(aw))
    b = PackedArray.from_words(lay, jnp.asarray(bw))
    batched = pt.add_unsigned_saturate(a, b)
    for i in range(0, 128, 17):
        single = pt.add_unsigned_saturate(a[i], b[i])
        assert int(single.word) == int(batched.word[i])


def test_ops_under_jit_and_vmap():
    lay = PackedLayout(8, 8, 8, 8)
    rng = np.random.default_rng(1)
    aw = jnp.asarray(rng.integers(0, 2**32, size=(64,), dtype=np.uint32))
    bw = jnp.asarray(rng.integers(0, 2**32, size=(64,), dtype=np.uint32))

    def f(x, y):
        pa = PackedArray.from_words(lay, x)
        pb = PackedArray.from_words(lay, y)
        return pt.add_signed_saturate(pa, pb).word

    direct = f(aw, bw)
    jitted = jax.jit(f)(aw, bw)
    vmapped = jax.vmap(f)(aw[:, None], bw[:, None])[:, 0]
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(jitted))
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(vmapped))


def test_operator_overloads():
    lay = PackedLayout(4, 4)
    a = P(lay, 3, 5)
    b = P(lay, 1, 4)
    assert int((a | b).word) == (int(a.word) | int(b.word))
    assert int((a & b).word) == (int(a.word) & int(b.word))
    assert int((a ^ b).word) == (int(a.word) ^ int(b.word))
    assert bool(a.equal(P(lay, 3, 5)))
    # operator!= (pint.hpp:779): true iff any word bit differs
    assert not bool(a.not_equal(P(lay, 3, 5)))
    assert bool(a.not_equal(b))
    batch = PackedArray.from_words(lay, jnp.asarray([0x35, 0x14], jnp.uint8))
    both = PackedArray.from_words(lay, jnp.asarray([0x35, 0x99], jnp.uint8))
    np.testing.assert_array_equal(
        np.asarray(batch.not_equal(both)), [False, True]
    )
    np.testing.assert_array_equal(
        np.asarray(batch.equal(both)), ~np.asarray(batch.not_equal(both))
    )
    with pytest.raises(ValueError):
        a.not_equal(P(PackedLayout(4, 5), 1, 1))
    with pytest.raises(ValueError):
        pt.add_wrap(a, P(PackedLayout(4, 5), 1, 1))
