"""Receding-horizon MPC controller: closed loop of solve -> apply -> re-solve.

Couples the fixed-point PGD solver to the quantized dynamics: each control
tick solves the condensed QP from the current (fixed-point) state, applies
the first control lane, and steps the plant.  The entire closed loop is one
jitted `lax.scan` -- solver iterations, packed saturating updates, int8
matmuls and the plant step all fuse into a single XLA program with no host
round-trips, which is the device-resident shape of a production control
loop.

Warm starting: the packed control iterate is shifted one word-lane left
between ticks (the classic MPC warm start), implemented with the packed
lane-shift machinery on the control words themselves.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    DoubleIntegrator,
    pack_controls,
    unpack_controls,
)
from pint_jax.mpc.condensed import QuantizedQP
from pint_jax.mpc.solver import FixedPointPGD

Array = jax.Array

__all__ = ["LTIController", "RecedingHorizonController"]


@dataclasses.dataclass(frozen=True)
class LTIController:
    """Generic receding-horizon controller for any quantized LTI MPC.

    Couples a :class:`~pint_jax.mpc.condensed.QuantizedQP` (built with
    ``condense_lti``, any state dim n / input dim m) to a fixed-point plant
    step ``plant_step(state_fp, u_lanes) -> state_fp`` where ``u_lanes`` is
    the (..., m) int32 first-step control.  The per-tick linear term is the
    folded float32 matmul of the physical state (states are int32 Q
    ``frac_bits``); the warm start shifts the packed plan by m lanes.

    Used by the quadrotor hover loop (tests/test_quadrotor.py); the
    double-integrator convenience wrapper below predates it.
    """

    qqp: QuantizedQP
    plant_step: callable = dataclasses.field(repr=False)
    inputs_per_step: int = 1
    frac_bits: int = 16
    iters_per_tick: int = 15
    use_fused: bool = False
    """Solve ticks with the single-launch kernel (:class:`~pint_jax.mpc.
    fused.FusedPGD`, bit-identical)."""
    error_feedback: bool = False
    interpret: bool = False
    """Run the fused kernel in the Pallas interpreter (CPU tests)."""

    @functools.cached_property
    def _solver(self):
        if self.use_fused:
            from pint_jax.mpc.fused import FusedPGD

            return FusedPGD(
                self.qqp, iters=self.iters_per_tick, interpret=self.interpret
            )
        return FixedPointPGD(
            self.qqp,
            iters=self.iters_per_tick,
            error_feedback=self.error_feedback,
        )

    @functools.cached_property
    def _g_mat(self) -> np.ndarray:
        scale = self.qqp.Gq_scale * 2.0**-self.frac_bits
        n = self.qqp.qp.G.shape[1]
        G = np.zeros((n, self.qqp.padded), np.float32)
        G[:, : self.qqp.horizon] = (self.qqp.qp.G * scale).T.astype(np.float32)
        return G

    @functools.cached_property
    def _g_ref(self) -> np.ndarray:
        gr = np.zeros((self.qqp.padded,), np.float32)
        gr[: self.qqp.horizon] = (
            self.qqp.qp.g_ref * self.qqp.Gq_scale
        ).astype(np.float32)
        return gr

    def tick(self, state_fp: Array, u_words: Array):
        g = jnp.round(
            state_fp.astype(jnp.float32) @ jnp.asarray(self._g_mat)
            + jnp.asarray(self._g_ref)
        ).astype(jnp.int32)
        u_words = self._solver.solve_words(u_words, g)
        lanes = unpack_controls(u_words)
        m = self.inputs_per_step
        u0 = lanes[..., :m]
        state2 = self.plant_step(state_fp, u0)
        shifted = jnp.concatenate(
            [lanes[..., m:], jnp.zeros_like(lanes[..., :m])], axis=-1
        )
        return state2, pack_controls(shifted), u0

    def run(self, state0_fp: Array, ticks: int):
        """Closed loop; returns (states (B, ticks+1, n), applied controls
        (B, ticks, m))."""
        u0_words = jnp.zeros(
            state0_fp.shape[:-1] + (self.qqp.padded // 4,), jnp.uint32
        )

        def body(carry, _):
            state, words = carry
            state2, words2, u0 = self.tick(state, words)
            return (state2, words2), (state2, u0)

        (_, _), (states, lanes) = jax.lax.scan(
            body, (state0_fp, u0_words), None, length=ticks
        )
        states = jnp.moveaxis(states, 0, -2)   # (B, ticks, n)
        lanes = jnp.moveaxis(lanes, 0, -2)     # (B, ticks, m)
        states = jnp.concatenate([state0_fp[..., None, :], states], axis=-2)
        return states, lanes


@dataclasses.dataclass(frozen=True)
class RecedingHorizonController:
    """Closed-loop quantized MPC for the double integrator.

    Consistency requirement: the QP's control box and the model's lane
    scaling must agree -- the plant applies ``lane * model.u_scale`` while
    the QP bounds ``|u| <= u_max`` with lane scale ``u_max / 127``.  Use
    :meth:`build` to construct a matched pair (u_max = 127 * model.u_scale,
    dt = model.dt).
    """

    qqp: QuantizedQP
    model: DoubleIntegrator = DoubleIntegrator()
    iters_per_tick: int = 15
    use_fused: bool = False  # solve ticks with the single-launch kernel
    interpret: bool = False  # ... in the Pallas interpreter (CPU tests)

    def __post_init__(self):
        if abs(self.qqp.u_scale - self.model.u_scale) > 1e-12:
            raise ValueError(
                f"QP lane scale {self.qqp.u_scale} != model lane scale "
                f"{self.model.u_scale}; build the QP with "
                f"u_max = 127 * model.u_scale (use .build())"
            )

    @classmethod
    def build(
        cls,
        model: DoubleIntegrator = DoubleIntegrator(),
        horizon: int = 50,
        iters_per_tick: int = 15,
        **qp_kwargs,
    ) -> "RecedingHorizonController":
        from pint_jax.mpc.condensed import condense_double_integrator, quantize

        qp = condense_double_integrator(
            T=horizon,
            dt=model.dt,
            u_max=127 * model.u_scale,
            **qp_kwargs,
        )
        return cls(quantize(qp), model, iters_per_tick)

    @functools.cached_property
    def _solver(self):
        if self.use_fused:
            from pint_jax.mpc.fused import FusedPGD

            return FusedPGD(
                self.qqp, iters=self.iters_per_tick, interpret=self.interpret
            )
        return FixedPointPGD(self.qqp, iters=self.iters_per_tick)

    @functools.cached_property
    def _g_mat(self) -> np.ndarray:
        """Fixed-point map from int32 Q-state to the QP's pre-shift linear
        term: g_pre = round(state_fp * Gq_scale * G^T * 2^-frac).

        Folded into a float32 matrix applied on device (the only float op in
        the loop; exactness is not required for g -- it is data, not
        iterate).  Cached as HOST numpy (never device arrays: a
        cached_property evaluated inside a jit trace would cache a tracer).
        """
        scale = self.qqp.Gq_scale * 2.0**-self.model.frac_bits
        G = np.zeros((2, self.qqp.padded), np.float32)
        G[:, : self.qqp.horizon] = (self.qqp.qp.G * scale).T.astype(np.float32)
        return G

    @functools.cached_property
    def _g_ref(self) -> np.ndarray:
        gr = np.zeros((self.qqp.padded,), np.float32)
        gr[: self.qqp.horizon] = (
            self.qqp.qp.g_ref * self.qqp.Gq_scale
        ).astype(np.float32)
        return gr

    def _g_pre(self, state_fp: Array) -> Array:
        g = state_fp.astype(jnp.float32) @ jnp.asarray(self._g_mat)
        g = g + jnp.asarray(self._g_ref)
        return jnp.round(g).astype(jnp.int32)

    def tick(self, state_fp: Array, u_words: Array) -> Tuple[Array, Array, Array]:
        """One control tick.  state_fp: (B, 2) int32; u_words: (B, Tp/4).

        Returns (next_state, next_u_words, applied_lane)."""
        g_pre = self._g_pre(state_fp)
        u_words = self._solver.solve_words(u_words, g_pre)
        lanes = unpack_controls(u_words)
        u0 = lanes[..., 0]
        next_state = self.model.step(state_fp, u0)
        # warm start: shift the control plan one step earlier.  Lane k of
        # word j holds step 4j+k, so the shift is lanes[1:] ++ 0.
        shifted = jnp.concatenate(
            [lanes[..., 1:], jnp.zeros_like(lanes[..., :1])], axis=-1
        )
        return next_state, pack_controls(shifted), u0

    def run(self, state0_fp: Array, ticks: int):
        """Closed loop for ``ticks`` steps; returns (states (B,ticks+1,2),
        applied control lanes (B,ticks))."""

        u0_words = jnp.zeros(
            state0_fp.shape[:-1] + (self.qqp.padded // 4,), jnp.uint32
        )

        def body(carry, _):
            state, words = carry
            state2, words2, u0 = self.tick(state, words)
            return (state2, words2), (state2, u0)

        (_, _), (states, lanes) = jax.lax.scan(
            body, (state0_fp, u0_words), None, length=ticks
        )
        states = jnp.moveaxis(states, 0, -2)
        lanes = jnp.moveaxis(lanes, 0, -1)
        states = jnp.concatenate([state0_fp[..., None, :], states], axis=-2)
        return states, lanes
