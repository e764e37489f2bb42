"""`PackedArray`: the user-facing packed-lane tensor type.

JAX analog of ``pint::packed_int`` (pint.hpp:758-787): where the
reference wraps ONE machine word, a :class:`PackedArray` wraps an arbitrary
batch of words as a JAX array plus a static :class:`PackedLayout`.  It is a
registered pytree, so it flows through jit/vmap/scan/shard_map and can be
donated, sharded and checkpointed like any other array.

The free functions at the bottom mirror the reference's public op surface
(pint.hpp:799-1029) 1:1 by name, so reference users can port call sites
mechanically::

    lay = PackedLayout(5, 6, 5)                 # make_packed_int<5,6,5>
    a = PackedArray.pack(lay, [1, 20, 10])      # PackedInt(1, 20, 10)
    b = PackedArray.pack(lay, [3, 2, 1])
    s = add_wrap(a, b)                          # pint::add_wrap(a, b)
    s.lanes()                                   # ToArray / get<I>
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.layout import PackedLayout
from pint_jax.ops import word as W

Array = jax.Array

__all__ = [
    "PackedArray",
    "get",
    "get_signed",
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
    "slice_lanes",
]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PackedArray:
    """A tensor of packed words plus the lane layout describing them."""

    word: Array
    layout: PackedLayout

    # -- pytree protocol ----------------------------------------------------

    def tree_flatten(self):
        return (self.word,), self.layout

    @classmethod
    def tree_unflatten(cls, layout, children):
        return cls(children[0], layout)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_words(cls, layout: PackedLayout, words) -> "PackedArray":
        """Wrap raw words (the ``packed_int(value)`` ctor, pint.hpp:768)."""
        return cls(W._as_word(layout, words), layout)

    @classmethod
    def pack(cls, layout: PackedLayout, *lanes) -> "PackedArray":
        """Pack per-lane values with truncation (pint.hpp:770-774).

        Accepts one array per lane, a single lanes-last stacked array, or a
        flat python sequence of scalars (one per lane).
        """
        if len(lanes) == 1 and isinstance(lanes[0], (list, tuple)):
            lanes = tuple(lanes[0])
        return cls(W.pack(layout, *lanes), layout)

    @classmethod
    def zeros(cls, layout: PackedLayout, shape=()) -> "PackedArray":
        return cls(jnp.zeros(shape, dtype=layout.word_dtype), layout)

    # -- views --------------------------------------------------------------

    @property
    def shape(self):
        return self.word.shape

    @property
    def dtype(self):
        return self.word.dtype

    def value(self) -> Array:
        """The raw word tensor (``packed_int::value``, pint.hpp:776)."""
        return self.word

    def get(self, index: int) -> Array:
        return W.get(self.layout, self.word, index)

    def get_signed(self, index: int) -> Array:
        return W.get_signed(self.layout, self.word, index)

    def lanes(self) -> Array:
        """All lanes zero-extended, stacked on a trailing axis."""
        return W.unpack(self.layout, self.word)

    def lanes_signed(self) -> Array:
        return W.unpack_signed(self.layout, self.word)

    def astype_words(self, dtype) -> "PackedArray":
        return PackedArray(self.word.astype(dtype), self.layout)

    # -- operators (pint.hpp:776-783) ---------------------------------------

    def _check(self, other: "PackedArray"):
        if not isinstance(other, PackedArray):
            raise TypeError(f"expected PackedArray, got {type(other)!r}")
        if other.layout != self.layout:
            raise ValueError(
                f"layout mismatch: {self.layout} vs {other.layout}"
            )

    def __or__(self, other):
        self._check(other)
        return PackedArray(self.word | other.word, self.layout)

    def __and__(self, other):
        self._check(other)
        return PackedArray(self.word & other.word, self.layout)

    def __xor__(self, other):
        self._check(other)
        return PackedArray(self.word ^ other.word, self.layout)

    def __invert__(self):
        return PackedArray(~self.word, self.layout)

    def equal(self, other) -> Array:
        """Elementwise word equality (``operator==``, pint.hpp:778)."""
        self._check(other)
        return self.word == other.word

    def not_equal(self, other) -> Array:
        """Elementwise word inequality (``operator!=``, pint.hpp:779).

        Python's ``==``/``!=`` are left at dataclass identity semantics
        (a PackedArray holds a traced JAX array, whose truthiness is
        ambiguous elementwise); the reference's value comparisons map to
        :meth:`equal` / :meth:`not_equal`, which return boolean arrays.
        """
        self._check(other)
        return self.word != other.word

    def __getitem__(self, idx):
        return PackedArray(self.word[idx], self.layout)

    def reshape(self, *shape):
        return PackedArray(self.word.reshape(*shape), self.layout)

    def __repr__(self):
        # readable per-lane repr, mirroring the GTest PrintTo helper
        # (pint_test.cpp:46-56)
        try:
            lanes = np.asarray(self.lanes())
            return f"PackedArray({self.layout}, lanes={lanes.tolist()})"
        except Exception:
            return f"PackedArray({self.layout}, word={self.word!r})"


def _binop(name):
    fn = getattr(W, name)

    def op(a: PackedArray, b: PackedArray) -> PackedArray:
        a._check(b)
        return PackedArray(fn(a.layout, a.word, b.word), a.layout)

    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = fn.__doc__
    return op


add_wrap = _binop("add_wrap")
add_unsigned_saturate = _binop("add_unsigned_saturate")
add_signed_saturate = _binop("add_signed_saturate")
sub_wrap = _binop("sub_wrap")
sub_unsigned_saturate = _binop("sub_unsigned_saturate")
sub_signed_saturate = _binop("sub_signed_saturate")
min_unsigned = _binop("min_unsigned")
max_unsigned = _binop("max_unsigned")
min_signed = _binop("min_signed")
max_signed = _binop("max_signed")


def get(a: PackedArray, index: int) -> Array:
    """Lane ``index`` zero-extended (pint.hpp:799-807)."""
    return a.get(index)


def get_signed(a: PackedArray, index: int) -> Array:
    """Lane ``index`` sign-extended (pint.hpp:809-822)."""
    return a.get_signed(index)


def shift_left(a: PackedArray, amount) -> PackedArray:
    """Per-lane left shift by runtime amount (pint.hpp:1006-1017)."""
    return PackedArray(W.shift_left(a.layout, a.word, amount), a.layout)


def shift_right_unsigned(a: PackedArray, amount) -> PackedArray:
    """Per-lane logical right shift by runtime amount (pint.hpp:1019-1029)."""
    return PackedArray(
        W.shift_right_unsigned(a.layout, a.word, amount), a.layout
    )


def slice_lanes(a: PackedArray, start: int, end: int) -> PackedArray:
    """Lanes [start, end) as a new PackedArray (pint.hpp:923-932)."""
    sub, word = W.slice_word(a.layout, a.word, start, end)
    return PackedArray(word, sub)
