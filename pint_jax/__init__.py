"""pint-jax: a JAX packed-integer (SWAR) lane-arithmetic framework
with a fixed-point MPC stack on top.

Re-designs the capabilities of the reference C++ library ``bad-ed/pint``
(header-only compile-time SWAR, /root/reference/include/pint/pint.hpp) as an
idiomatic JAX/XLA/Pallas stack:

* :mod:`pint_jax.layout`  -- trace-time mask machinery (replaces the C++
  template metaprogramming layers, pint.hpp:27-756)
* :mod:`pint_jax.ops`     -- branch-free lane formulas and their jitted
  whole-array entry points (replaces pint.hpp:758-1031)
* :mod:`pint_jax.packed`  -- the :class:`PackedArray` pytree type
* :mod:`pint_jax.models`  -- quantized dynamics (double integrator, unicycle)
* :mod:`pint_jax.mpc`     -- fixed-point box-constrained condensed-QP MPC
* :mod:`pint_jax.parallel`-- mesh / shard_map / collective utilities
* :mod:`pint_jax.utils`   -- CPU oracle, roofline bench helpers
"""

from pint_jax.layout import PackedLayout, word_bits_for
from pint_jax.packed import (
    PackedArray,
    add_signed_saturate,
    add_unsigned_saturate,
    add_wrap,
    get,
    get_signed,
    max_signed,
    max_unsigned,
    min_signed,
    min_unsigned,
    shift_left,
    shift_right_unsigned,
    slice_lanes,
    sub_signed_saturate,
    sub_unsigned_saturate,
    sub_wrap,
)

__version__ = "0.1.0"

__all__ = [
    "PackedLayout",
    "PackedArray",
    "word_bits_for",
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
