"""Quantization-aware nonlinear MPC: autodiff gradients, packed iterates.

The gradient-based complement to the sampling planner
(:mod:`pint_jax.mpc.mppi`) for nonlinear dynamics.  The trick that makes it
batched AND quantized:

* The **iterate is the packed int8 control plan** (SWAR words), exactly the
  artifact the quantized rollout engine consumes -- there is no separate
  float plan that later gets quantized.
* The **gradient comes from autodiff through a float32 twin** of the
  fixed-point dynamics (`Unicycle.rollout_f32`, same discrete map and the
  same quadratic trig), i.e. a straight-through estimator: forward in int,
  backward in float.
* The **update is the saturating packed control law**: the float gradient
  is normalized per problem (RMS over the plan), scaled to lane units by a
  cosine-decayed step, rounded, and applied with ``add_signed_saturate`` +
  the ``max_signed`` box floor -- identical machinery to the linear solver.

The whole solve is one jitted `lax.fori_loop`: rollout + backprop (scan and
its transpose), normalization, packed update.  No line search, no
data-dependent control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_jax.ops import word as W

Array = jax.Array

__all__ = ["QuantizedNonlinearPGD"]


@dataclasses.dataclass(frozen=True)
class QuantizedNonlinearPGD:
    """Normalized-gradient descent on packed int8 plans for the unicycle."""

    model: Unicycle = Unicycle()
    horizon: int = 50
    iters: int = 60
    step_lanes: float = 12.0   # initial step, int8 lane units (RMS)
    final_lanes: float = 0.5   # final step after cosine decay

    @property
    def words_per_plan(self) -> int:
        return (2 * self.horizon) // 4

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.words_per_plan), jnp.uint32)

    @property
    def _lane_scales(self) -> np.ndarray:
        """(2,) physical units per lane for (v, w) channels."""
        return np.array(
            [self.model.v_scale, self.model.w_scale], np.float32
        )

    def _lower_words(self) -> Array:
        w = 0
        for off in CONTROL_LAYOUT.offsets:
            w |= (-127 & 0xFF) << off
        return jnp.full((1,), np.uint32(w), jnp.uint32)

    def solve_words(
        self,
        u_words: Array,            # (B, words_per_plan)
        state0_f: Array,           # (B, 3) float32 physical (theta in turns)
        cost_fn: Callable[[Array, Array], Array],
    ) -> Array:
        """``iters`` quantization-aware gradient steps on packed words."""
        scales = jnp.asarray(self._lane_scales)

        def objective(u_phys):
            states = self.model.rollout_f32(state0_f, u_phys)
            return jnp.sum(cost_fn(states, u_phys))

        grad_fn = jax.grad(objective)

        def body(i, words):
            lanes = unpack_controls(words)             # (B, 2T) int32
            ctrl = lanes.reshape(*lanes.shape[:-1], self.horizon, 2)
            u_phys = ctrl.astype(jnp.float32) * scales
            g = grad_fn(u_phys)                        # (B, T, 2) float32
            # per-problem RMS normalization -> step in lane units
            g_lane = g * scales                        # d cost / d lane
            rms = jnp.sqrt(
                jnp.mean(g_lane * g_lane, axis=(-2, -1), keepdims=True)
            ) + 1e-12
            frac = i.astype(jnp.float32) / np.float32(max(self.iters - 1, 1))
            lr = np.float32(self.final_lanes) + np.float32(
                0.5 * (self.step_lanes - self.final_lanes)
            ) * (1.0 + jnp.cos(np.float32(np.pi) * frac))
            delta = -lr * g_lane / rms
            delta_lanes = jnp.clip(
                jnp.round(delta), -127, 127
            ).astype(jnp.int32)
            delta_lanes = delta_lanes.reshape(*lanes.shape)
            words = W.add_signed_saturate(
                CONTROL_LAYOUT, words, pack_controls(delta_lanes)
            )
            return W.max_signed(
                CONTROL_LAYOUT,
                words,
                jnp.broadcast_to(self._lower_words(), words.shape),
            )

        return jax.lax.fori_loop(0, self.iters, body, u_words)

    # -- closed loop ---------------------------------------------------------

    def run_closed_loop(
        self,
        state0_fp: Array,          # (B, 3) int32
        cost_fn,
        ticks: int,
        iters_per_tick: int = 8,
    ) -> Tuple[Array, Array]:
        """Receding-horizon gradient MPC: per tick, refine the warm-started
        packed plan with ``iters_per_tick`` gradient steps, apply the first
        (v, w) pair on the QUANTIZED plant, shift the plan.  One jitted
        `lax.scan`; fully deterministic (no sampling).

        Returns (states (B, ticks+1, 3) int32, applied controls
        (B, ticks, 2) int32 lanes)."""
        tick_solver = dataclasses.replace(self, iters=iters_per_tick)
        batch = state0_fp.shape[0]

        def to_f(state):
            return jnp.concatenate(
                [
                    state[..., :2].astype(jnp.float32)
                    * np.float32(2.0**-self.model.frac_bits),
                    state[..., 2:].astype(jnp.float32) * np.float32(2.0**-16),
                ],
                axis=-1,
            )

        def tick(carry, _):
            state, words = carry
            words = tick_solver.solve_words(words, to_f(state), cost_fn)
            lanes = unpack_controls(words)
            v0, w0 = lanes[..., 0], lanes[..., 1]
            state2 = self.model.step(state, v0, w0)
            shifted = jnp.concatenate(
                [lanes[..., 2:], jnp.zeros_like(lanes[..., :2])], axis=-1
            )
            return (state2, pack_controls(shifted)), (
                state2,
                jnp.stack([v0, w0], axis=-1),
            )

        (_, _), (states, ctrl) = jax.lax.scan(
            tick, (state0_fp, self.init_words(batch)), None, length=ticks
        )
        states = jnp.moveaxis(states, 0, -2)
        ctrl = jnp.moveaxis(ctrl, 0, -2)
        states = jnp.concatenate([state0_fp[..., None, :], states], axis=-2)
        return states, ctrl

    def solve(
        self, state0_fp: Array, cost_fn
    ) -> Tuple[Array, Array]:
        """From fixed-point states; returns (words, quantized trajectory)."""
        state0_f = jnp.concatenate(
            [
                state0_fp[..., :2].astype(jnp.float32)
                * np.float32(2.0**-self.model.frac_bits),
                (
                    state0_fp[..., 2:].astype(jnp.float32)
                    * np.float32(2.0**-16)
                ),
            ],
            axis=-1,
        )
        words = self.solve_words(
            self.init_words(state0_fp.shape[0]), state0_f, cost_fn
        )
        lanes = unpack_controls(words)
        ctrl = lanes.reshape(*lanes.shape[:-1], self.horizon, 2)
        states = self.model.rollout(state0_fp, ctrl)
        return words, states
