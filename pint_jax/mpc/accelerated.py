"""Accelerated fixed-point PGD (heavy-ball/FISTA-style momentum).

Plain PGD contracts slowly in weakly-curved directions (the default QP has
kappa ~ 100, so 1 - 1/kappa per iteration); Nesterov-style extrapolation
contracts at ~1 - 1/sqrt(kappa).  The fixed-point form:

    y   = clip(x + (beta * (x - x_prev)),  box)     # extrapolate, int32
    x+  = clip(y - quantized_step(grad(y)), box)    # usual PGD step

with beta = (sqrt(kappa)-1)/(sqrt(kappa)+1) represented as an integer
rational ``beta_num / 2^beta_den``.  Clamping the extrapolate to the box
(projected momentum) keeps the int8 matmul input in range; for box-constrained
QPs this is the standard practical variant.

The iterate pair (x, x_prev) lives as packed SWAR words; the extrapolation
and update run in lane space (bit-equivalent to the packed saturating ops,
see mpc/fused.py docstring) and re-pack each iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import pack_controls, unpack_controls
from pint_jax.mpc.condensed import QuantizedQP

Array = jax.Array

__all__ = ["AcceleratedPGD"]


@dataclasses.dataclass(frozen=True)
class AcceleratedPGD:
    """Momentum-accelerated fixed-point solver (same interface family)."""

    qqp: QuantizedQP
    iters: int = 20
    beta_den: int = 8  # beta quantized to 2^-8

    @functools.cached_property
    def beta_num(self) -> int:
        H = self.qqp.qp.H
        eig = np.linalg.eigvalsh(H)
        kappa = float(eig.max() / max(eig.min(), 1e-12))
        rk = np.sqrt(kappa)
        beta = (rk - 1.0) / (rk + 1.0)
        return int(round(beta * (1 << self.beta_den)))

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.qqp.padded // 4), jnp.uint32)

    def solve_words(self, u_words: Array, g_pre: Array) -> Array:
        qqp = self.qqp
        Hq = jnp.asarray(qqp.Hq)
        hs_num = np.int32(qqp.hs_num)
        hs_den = np.int32(qqp.hs_den)
        g_shift = np.int32(qqp.g_shift)
        half = np.int32(1 << (qqp.g_shift - 1))
        bnum = np.int32(self.beta_num)
        bden = np.int32(self.beta_den)

        def body(_, carry):
            x_words, xp_words = carry
            x = unpack_controls(x_words)
            xp = unpack_controls(xp_words)
            y = jnp.clip(x + ((bnum * (x - xp)) >> bden), -127, 127)
            acc = jax.lax.dot_general(
                y.astype(jnp.int8),
                Hq,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            pre = (acc * hs_num) >> hs_den
            step = -(pre + g_pre)
            delta = jnp.clip((step + half) >> g_shift, -128, 127)
            x_new = jnp.clip(y + delta, -127, 127)
            return pack_controls(x_new), x_words

        x_final, _ = jax.lax.fori_loop(
            0, self.iters, body, (u_words, u_words)
        )
        return x_final

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array]:
        g_pre = jnp.asarray(self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)))
        u0 = self.init_words(g_pre.shape[0])
        words = jax.jit(self.solve_words)(u0, g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return words, lanes.astype(jnp.float32) * np.float32(self.qqp.u_scale)
