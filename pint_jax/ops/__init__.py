"""Lane arithmetic: the branch-free formulas (:mod:`pint_jax.ops.word`),
their u64 split-word form (:mod:`pint_jax.ops.split64`) and jitted
whole-array entry points (:mod:`pint_jax.ops.elementwise`)."""

from pint_jax.ops import word

__all__ = ["word"]
