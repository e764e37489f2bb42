"""Fixed-point projected-gradient MPC solver (single device).

The device inner loop for the box-constrained condensed QP of
:mod:`pint_jax.mpc.condensed`, built entirely from integer primitives:

* **int8 matmul**: the gradient matmul runs int8 x int8 -> int32
  (``preferred_element_type=jnp.int32``).
* **int32 rescale**: the step rescale is one int32 multiply + arithmetic shift
  (``hs_num``/``hs_den`` rational from quantization time).
* **SWAR substrate**: the control iterate lives as int8 lanes packed
  4-per-uint32; the iterate update is ``add_signed_saturate`` on packed
  words and the box floor re-clamp is packed ``max_signed`` -- i.e. the
  saturating packed control update of BASELINE.json, exercising the pint
  capability set (pint.hpp:857-866, 987-1004) on every iteration.
* **No data-dependent control flow**: a `lax.fori_loop` with a static trip
  count; everything jit-compiles to one XLA program.

The whole solver is a pure function on pytrees; `vmap`/`shard_map` batch it
across problems (8192 rollouts in the headline config).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    CONTROL_LAYOUT,
    pack_controls,
    unpack_controls,
)
from pint_jax.mpc.condensed import QuantizedQP
from pint_jax.ops import word as W

Array = jax.Array

__all__ = ["FixedPointPGD"]


@dataclasses.dataclass(frozen=True)
class FixedPointPGD:
    """Configured solver for one quantized QP (shared across the batch)."""

    qqp: QuantizedQP
    iters: int = 40
    error_feedback: bool = False
    """Carry the sub-lane rounding residual between iterations.

    Each update quantizes the step to whole int8 lanes; with error feedback
    the discarded fraction (in 2^-g_shift lane units) accumulates in an
    int32 side plane and is re-injected next iteration, so step components
    smaller than one lane still integrate instead of vanishing -- tighter
    convergence in weakly-curved directions at the cost of one extra
    (B, Tp) int32 state plane.
    """

    # -- constants (cached as HOST numpy: a cached_property evaluated inside
    # a jit trace must never cache a tracer) --------------------------------

    @property
    def Hq_dev(self) -> Array:
        return jnp.asarray(self.qqp.Hq)  # (Tp, Tp) int8

    @functools.cached_property
    def _lower_word(self) -> np.ndarray:
        """The packed word of four lane lower bounds (-127): the symmetric
        box's floor, re-applied after the saturating update (saturation
        floor is -128)."""
        w = 0
        for off in CONTROL_LAYOUT.offsets:
            w |= (-127 & 0xFF) << off
        return np.uint32(w)

    @property
    def lower_words(self) -> Array:
        return jnp.full((1,), self._lower_word, jnp.uint32)

    # -- one PGD iteration on packed words ---------------------------------

    def _iterate(self, u_words: Array, g_pre: Array) -> Array:
        """u_words: (B, Tp/4) uint32; g_pre: (B, Tp) int32 pre-shift lane
        units."""
        lanes = unpack_controls(u_words)  # (B, Tp) int32
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            self.Hq_dev,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (B, Tp) int32 = U @ Hq^T
        pre = (acc * np.int32(self.qqp.hs_num)) >> np.int32(self.qqp.hs_den)
        step = -(pre + g_pre)
        # round-to-nearest lane delta, clamped into int8 pack range
        half = np.int32(1 << (self.qqp.g_shift - 1))
        delta = (step + half) >> np.int32(self.qqp.g_shift)
        delta = jnp.clip(delta, -128, 127)
        delta_words = pack_controls(delta)
        u_words = W.add_signed_saturate(CONTROL_LAYOUT, u_words, delta_words)
        # box floor: saturation reaches -128, the box stops at -127
        u_words = W.max_signed(
            CONTROL_LAYOUT, u_words, jnp.broadcast_to(self.lower_words, u_words.shape)
        )
        return u_words

    # -- public API ---------------------------------------------------------

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.qqp.padded // 4), jnp.uint32)

    def _iterate_ef(self, u_words: Array, carry: Array, g_pre: Array):
        """Error-feedback iteration: (words, carry) -> (words, carry)."""
        lanes = unpack_controls(u_words)
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            self.Hq_dev,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        pre = (acc * np.int32(self.qqp.hs_num)) >> np.int32(self.qqp.hs_den)
        step = -(pre + g_pre) + carry
        half = np.int32(1 << (self.qqp.g_shift - 1))
        delta = jnp.clip(
            (step + half) >> np.int32(self.qqp.g_shift), -128, 127
        )
        carry = step - (delta << np.int32(self.qqp.g_shift))
        u_words = W.add_signed_saturate(
            CONTROL_LAYOUT, u_words, pack_controls(delta)
        )
        u_words = W.max_signed(
            CONTROL_LAYOUT,
            u_words,
            jnp.broadcast_to(self.lower_words, u_words.shape),
        )
        return u_words, carry

    def solve_words(self, u_words: Array, g_pre: Array) -> Array:
        """Run ``iters`` PGD steps.  Pure function: jit/vmap/shard_map safe."""

        if self.error_feedback:
            def body_ef(_, state):
                return self._iterate_ef(state[0], state[1], g_pre)

            carry0 = jnp.zeros(g_pre.shape, jnp.int32)
            words, _ = jax.lax.fori_loop(
                0, self.iters, body_ef, (u_words, carry0)
            )
            return words

        def body(_, u):
            return self._iterate(u, g_pre)

        return jax.lax.fori_loop(0, self.iters, body, u_words)

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array]:
        """Convenience end-to-end solve for a batch of initial states.

        Returns (packed words, physical control sequences (B, T) float32).
        """
        g_pre = jnp.asarray(self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)))
        u0 = self.init_words(g_pre.shape[0])
        words = jax.jit(self.solve_words)(u0, g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.astype(jnp.float32) * np.float32(self.qqp.u_scale)

    # -- diagnostics ---------------------------------------------------------

    def cost(self, lanes_phys: np.ndarray, x0_phys: np.ndarray) -> np.ndarray:
        """Float64 QP objective of a (batch of) control sequences."""
        qp = self.qqp.qp
        U = np.asarray(lanes_phys, np.float64)
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        g = x0 @ qp.G.T + qp.g_ref
        return 0.5 * np.einsum("bi,ij,bj->b", U, qp.H, U) + np.einsum(
            "bi,bi->b", g, U
        )
