"""u64-as-2xu32 split-word layer: exactness vs the x64 jnp path.

Two levels:
* SplitWord arithmetic itself (add/sub/shift/bitwise) vs Python big-int
  semantics mod 2^64 -- the carry/borrow seam at bit 32 is the risk surface.
* Every public SWAR op evaluated through SplitView vs the uint64 jnp path,
  over layouts chosen to straddle the 32-bit boundary (lane spanning bits
  20..39), repeat widths (saturation strategy type 2), a single 33-bit lane,
  and the reference's u64 bench config 8x8 (pint_bench.cpp:468-485).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pint_jax import PackedLayout
from pint_jax.ops import elementwise as P
from pint_jax.ops import split64 as S
from pint_jax.ops import word as W

M64 = (1 << 64) - 1

LAYOUTS = [
    PackedLayout(*([8] * 8)),           # u64 bench config
    PackedLayout(20, 20, 24),           # lane 1 straddles bit 32
    PackedLayout(7, 7, 9, 9, 11, 12),   # repeated hetero widths (sat type 2)
    PackedLayout(33),                   # single lane wider than a half
    PackedLayout(1, 2, 3, 4, 5, 6, 11, 10, 9, 8),
    PackedLayout(5, 59),
]


def _rand_u64(layout, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, M64, size=n, dtype=np.uint64, endpoint=True)
    return jnp.asarray(w & np.uint64(layout.used_mask))


def test_splitword_add_sub_exact():
    rng = np.random.default_rng(0)
    a = rng.integers(0, M64, 2000, dtype=np.uint64, endpoint=True)
    b = rng.integers(0, M64, 2000, dtype=np.uint64, endpoint=True)
    # adversarial carry cases: all-ones, half boundaries
    special = np.array(
        [M64, 0xFFFFFFFF, 0x100000000, 0xFFFFFFFF00000000, 0, 1],
        dtype=np.uint64,
    )
    a = np.concatenate([a, special, special])
    b = np.concatenate([b, special[::-1], np.ones(6, np.uint64)])
    sa, sb = S.split_u64(jnp.asarray(a)), S.split_u64(jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(S.merge_u64(sa + sb)), a + b  # numpy wraps mod 2^64
    )
    np.testing.assert_array_equal(np.asarray(S.merge_u64(sa - sb)), a - b)


@pytest.mark.parametrize("k", [0, 1, 7, 31, 32, 33, 52, 63, 64])
def test_splitword_shifts_exact(k):
    rng = np.random.default_rng(k)
    a = rng.integers(0, M64, 500, dtype=np.uint64, endpoint=True)
    sa = S.split_u64(jnp.asarray(a))
    exp_l = (a << np.uint64(k)) if k < 64 else np.zeros_like(a)
    exp_r = (a >> np.uint64(k)) if k < 64 else np.zeros_like(a)
    # static path
    np.testing.assert_array_equal(np.asarray(S.merge_u64(sa << k)), exp_l)
    np.testing.assert_array_equal(np.asarray(S.merge_u64(sa >> k)), exp_r)
    # traced path (the in-kernel runtime-amount form)
    np.testing.assert_array_equal(
        np.asarray(S.merge_u64(sa.shl_full(jnp.uint32(k)))), exp_l
    )
    np.testing.assert_array_equal(
        np.asarray(S.merge_u64(sa.shr_full(jnp.uint32(k)))), exp_r
    )


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", P.BINOP_NAMES)
def test_split_view_binop_parity(layout, opname):
    a = _rand_u64(layout, 700, 1)
    b = _rand_u64(layout, 700, 2)
    f = getattr(W, opname)
    expected = np.asarray(f(layout, a, b))
    view = S.SplitView(layout)
    got = np.asarray(S.merge_u64(f(view, S.split_u64(a), S.split_u64(b))))
    np.testing.assert_array_equal(expected, got)


@pytest.mark.parametrize("layout", LAYOUTS[:4], ids=str)
@pytest.mark.parametrize("opname", P.SHIFT_NAMES)
@pytest.mark.parametrize("amount", [0, 1, 13, 31, 32, 33, 58, 63, 64, 200])
def test_split_view_shift_parity(layout, opname, amount):
    v = _rand_u64(layout, 300, 3)
    f = getattr(W, opname)
    expected = np.asarray(f(layout, v, amount))
    view = S.SplitView(layout)
    got = np.asarray(
        S.merge_u64(f(view, S.split_u64(v), jnp.int32(amount)))
    )
    np.testing.assert_array_equal(expected, got)


def _to_pair_np(w):
    """Planar (2, ...) pair words: [0]=low half, [1]=high half."""
    w = np.asarray(w)
    return np.stack(
        [w & np.uint64(0xFFFFFFFF), w >> np.uint64(32)], axis=0
    ).astype(np.uint32)


@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
@pytest.mark.parametrize("opname", P.BINOP_NAMES)
def test_split_binop_parity(layout, opname):
    """The pair-word entry vs the jnp u64 formulas, every op x every
    layout."""
    a = _rand_u64(layout, 1000, 4)
    b = _rand_u64(layout, 1000, 5)
    expected = _to_pair_np(getattr(W, opname)(layout, a, b))
    got = np.asarray(
        P.binop_pair(layout, opname)(
            jnp.asarray(_to_pair_np(a)), jnp.asarray(_to_pair_np(b))
        )
    )
    np.testing.assert_array_equal(expected, got)


@pytest.mark.parametrize("opname", P.SHIFT_NAMES)
@pytest.mark.parametrize("amount", [0, 3, 32, 40, 64, 100])
def test_split_shift_parity(opname, amount):
    layout = PackedLayout(20, 20, 24)
    v = _rand_u64(layout, 777, 6)
    expected = _to_pair_np(getattr(W, opname)(layout, v, amount))
    got = np.asarray(
        P.shift_pair(layout, opname)(jnp.asarray(_to_pair_np(v)), amount)
    )
    np.testing.assert_array_equal(expected, got)


@pytest.mark.parametrize("opname", ["add_unsigned_saturate", "shift_left"])
def test_u64_dispatch_is_jnp_path(opname):
    """P.binop/P.shift on uint64 words agree with the formulas."""
    layout = PackedLayout(*([8] * 8))
    a = _rand_u64(layout, 256, 30)
    b = _rand_u64(layout, 256, 31)
    if opname in P.SHIFT_NAMES:
        expected = getattr(W, opname)(layout, a, 9)
        got = P.shift(layout, opname)(a, 9)
    else:
        expected = getattr(W, opname)(layout, a, b)
        got = P.binop(layout, opname)(a, b)
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))


@pytest.mark.parametrize("signed", [False, True])
def test_split_saturating_accumulate(signed):
    layout = PackedLayout(*([8] * 8))
    steps = 3
    acc = _rand_u64(layout, 400, 7)
    deltas = jnp.stack([_rand_u64(layout, 400, 8 + s) for s in range(steps)])
    formula = W.add_signed_saturate if signed else W.add_unsigned_saturate
    expected = acc
    for s in range(steps):
        expected = formula(layout, expected, deltas[s])
    got = P.saturating_accumulate(layout, signed=signed, steps=steps)(
        acc, deltas
    )
    np.testing.assert_array_equal(np.asarray(expected), np.asarray(got))


@pytest.mark.parametrize("opname", ["add_signed_saturate", "min_unsigned"])
def test_pair_api(opname):
    """The x64-free pair-word entry matches the u64-array path
    bit-exactly."""
    layout = PackedLayout(20, 20, 24)
    a = _rand_u64(layout, 500, 20)
    b = _rand_u64(layout, 500, 21)
    expected = np.asarray(getattr(W, opname)(layout, a, b))
    got_pair = np.asarray(
        P.binop_pair(layout, opname)(
            jnp.asarray(_to_pair_np(a)), jnp.asarray(_to_pair_np(b))
        )
    )
    np.testing.assert_array_equal(_to_pair_np(expected), got_pair)


def test_pair_shift():
    layout = PackedLayout(*([8] * 8))
    v = _rand_u64(layout, 300, 22)
    for amount in (0, 9, 33, 64):
        expected = np.asarray(W.shift_right_unsigned(layout, v, amount))
        got = np.asarray(
            P.shift_pair(layout, "shift_right_unsigned")(
                jnp.asarray(_to_pair_np(v)), amount
            )
        )
        np.testing.assert_array_equal(_to_pair_np(expected), got)


def test_split_2d_shapes():
    layout = PackedLayout(7, 7, 9, 9, 11, 12)
    a = _rand_u64(layout, 31 * 41, 10).reshape(31, 41)
    b = _rand_u64(layout, 31 * 41, 11).reshape(31, 41)
    expected = _to_pair_np(W.min_signed(layout, a, b))
    got = np.asarray(
        P.binop_pair(layout, "min_signed")(
            jnp.asarray(_to_pair_np(a)), jnp.asarray(_to_pair_np(b))
        )
    )
    assert got.shape == (2, 31, 41) and got.dtype == np.uint32
    np.testing.assert_array_equal(expected, got)
