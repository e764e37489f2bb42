"""Quantized MPPI (sampling-based MPC) for nonlinear dynamics.

The condensed-QP solver (:mod:`pint_jax.mpc.solver`) covers linear dynamics;
for the nonlinear unicycle the batch-natural method is path-integral MPC:
thousands of perturbed quantized rollouts scored in parallel -- exactly the
"8192 rollouts, H=50" batch shape of BASELINE.json -- with the nominal plan
updated through the saturating packed control ops.

One MPPI step, all on device, one XLA program:

1. sample K int8 perturbation plans (scaled discrete noise);
2. candidates = ``add_signed_saturate(nominal_words, noise_words)`` --
   the packed saturating update IS the control-box projection;
3. rollout all K candidates through the fixed-point dynamics (`vmap` over
   the sample axis, `lax.scan` over the horizon);
4. cost each trajectory (int32 accumulators, converted once to float32 for
   the exponential weighting -- softmax needs floats, nothing else does);
5. new nominal = round(weighted mean of candidate lanes), re-packed.

Batch axis layout: (batch B of independent problems) x (K samples) x
(T horizon).  dp-sharding the problem batch makes this the multi-chip
rollout engine.
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

__all__ = ["QuantizedMPPI", "unicycle_goal_cost"]


def unicycle_goal_cost(model: Unicycle, goal_xy: Array):
    """Quadratic goal-reaching cost on fixed-point unicycle trajectories.

    states: (..., T+1, 3) int32; returns (...) float32.  Distances are
    evaluated in float32 from the fixed-point states (cost shaping does not
    need exactness; the *dynamics* stay integer-exact).
    """

    def cost(states: Array, controls: Array) -> Array:
        xy = states[..., :2].astype(jnp.float32) * np.float32(
            2.0**-model.frac_bits
        )
        # goal (..., 2) gains a horizon axis to broadcast over T+1
        goal = goal_xy.astype(jnp.float32)[..., None, :]
        d2 = jnp.sum((xy - goal) ** 2, axis=-1)
        # running distance + strong terminal term + small control effort
        run = jnp.sum(d2[..., 1:], axis=-1)
        term = 20.0 * d2[..., -1]
        effort = 1e-4 * jnp.sum(
            controls.astype(jnp.float32) ** 2, axis=(-2, -1)
        )
        return run + term + effort

    return cost


@dataclasses.dataclass(frozen=True)
class QuantizedMPPI:
    """MPPI over packed int8 control plans for the unicycle."""

    model: Unicycle = Unicycle()
    horizon: int = 50          # steps; 2 lanes (v, w) per step
    samples: int = 512         # K rollouts per problem per update
    noise_lanes: int = 24      # stddev of int8 perturbation, in lane units
    temperature: float = 0.1   # softmax temperature, in units of the robust
    #                            (median - best) cost spread; self-normalizing

    @property
    def lanes_per_plan(self) -> int:
        return 2 * self.horizon

    @property
    def words_per_plan(self) -> int:
        return self.lanes_per_plan // 4

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.words_per_plan), jnp.uint32)

    def _sample_noise(self, key, batch: int) -> Array:
        """(B, K, lanes) int32 discrete perturbations, clipped to int8."""
        z = jax.random.normal(
            key, (batch, self.samples, self.lanes_per_plan), jnp.float32
        )
        return jnp.clip(
            jnp.round(z * self.noise_lanes), -127, 127
        ).astype(jnp.int32)

    def step(
        self,
        key: Array,
        nominal_words: Array,   # (B, words_per_plan) uint32
        state0: Array,          # (B, 3) int32
        cost_fn: Callable[[Array, Array], Array],
    ) -> Tuple[Array, Array]:
        """One MPPI update; returns (new nominal words, mean best cost)."""
        batch = nominal_words.shape[0]
        noise = self._sample_noise(key, batch)                 # (B,K,L)
        noise_words = pack_controls(noise)                     # (B,K,L/4)
        cand_words = W.add_signed_saturate(
            CONTROL_LAYOUT, nominal_words[:, None, :], noise_words
        )                                                      # (B,K,L/4)
        lanes = unpack_controls(cand_words)                    # (B,K,L)
        ctrl = lanes.reshape(batch, self.samples, self.horizon, 2)
        states = self.model.rollout(
            jnp.broadcast_to(state0[:, None, :], (batch, self.samples, 3)),
            ctrl,
        )                                                      # (B,K,T+1,3)
        costs = cost_fn(states, ctrl)                          # (B,K)
        # self-normalized exponential weighting: temperature is measured in
        # units of (median - best) cost, a scale robust to heavy-tailed
        # penalties (e.g. obstacle barriers) that would inflate a stddev
        # and flatten the weights
        mu = jnp.min(costs, axis=-1, keepdims=True)
        med = jnp.median(costs, axis=-1, keepdims=True)
        scale = (med - mu) + 1e-6
        w = jax.nn.softmax(-(costs - mu) / (scale * self.temperature), axis=-1)
        mean_lanes = jnp.einsum("bk,bkl->bl", w, lanes.astype(jnp.float32))
        new_lanes = jnp.clip(jnp.round(mean_lanes), -127, 127).astype(
            jnp.int32
        )
        return pack_controls(new_lanes), jnp.min(costs, axis=-1)

    # -- closed loop ---------------------------------------------------------

    def run_closed_loop(
        self,
        key: Array,
        state0: Array,          # (B, 3) int32
        cost_fn,
        ticks: int,
        updates_per_tick: int = 2,
    ) -> Tuple[Array, Array]:
        """Receding-horizon MPPI: per tick, refine the nominal plan with
        ``updates_per_tick`` MPPI updates, apply the first (v, w) pair, step
        the plant, and warm-start by shifting the plan one step earlier.
        One jitted `lax.scan` end to end.

        Returns (states (B, ticks+1, 3), applied controls (B, ticks, 2)).
        """
        batch = state0.shape[0]

        def tick(carry, k):
            state, words = carry
            ks = jax.random.split(k, updates_per_tick)

            def upd(c, kk):
                w, _ = self.step(kk, c, state, cost_fn)
                return w, None

            words, _ = jax.lax.scan(upd, words, ks)
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

        keys = jax.random.split(key, ticks)
        (_, _), (states, ctrl) = jax.lax.scan(
            tick, (state0, self.init_words(batch)), keys
        )
        states = jnp.moveaxis(states, 0, -2)   # (B, ticks, 3)
        ctrl = jnp.moveaxis(ctrl, 0, -2)       # (B, ticks, 2)
        states = jnp.concatenate([state0[..., None, :], states], axis=-2)
        return states, ctrl

    def plan(
        self,
        key: Array,
        state0: Array,
        cost_fn,
        updates: int = 8,
    ) -> Tuple[Array, Array]:
        """Run ``updates`` MPPI iterations; returns (words, best costs)."""
        batch = state0.shape[0]

        def body(carry, k):
            words, _ = carry
            words, best = self.step(k, words, state0, cost_fn)
            return (words, best), None

        keys = jax.random.split(key, updates)
        (words, best), _ = jax.lax.scan(
            body,
            (self.init_words(batch), jnp.zeros((batch,), jnp.float32)),
            keys,
        )
        return words, best
