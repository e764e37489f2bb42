"""Serving layer: a persistent, warm-started MPC service.

Production shape for the control stack: a long-lived service object owns the
compiled solver and the warm-start state (packed control words per lane of
the client batch), accepts plain numpy state batches per tick, and returns
physical control sequences.  Everything device-side is jitted once at
construction; per-tick work is one dispatch.

Robustness (the framework's failure-detection story, SURVEY.md section 5):
every response is validated -- residual finite, controls inside the box --
and a failed validation resets the warm state for the affected rows rather
than poisoning subsequent ticks (PGD from a cold start is always feasible:
the iterate never leaves the box by construction).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import unpack_controls
from pint_jax.mpc.condensed import QuantizedQP
from pint_jax.mpc.solver import FixedPointPGD

__all__ = ["ConstrainedRTIService", "MPCService", "RTIService",
           "CRTI_BUDGET_S", "LTI_BUDGET_S", "RTI_BUDGET_S"]

LTI_BUDGET_S = 0.010
"""Default real-time budget for the LTI endpoint (:class:`MPCService`):
a 100 Hz control loop."""

RTI_BUDGET_S = 0.020
"""Default real-time budget for the nonlinear RTI endpoint
(:class:`RTIService`): a 50 Hz loop."""

CRTI_BUDGET_S = 0.020
"""Default real-time budget for the constrained RTI endpoint
(:class:`ConstrainedRTIService`): a 50 Hz loop."""


@dataclasses.dataclass
class ServiceStats:
    """Per-service counters.  ``deadline_misses`` counts ticks whose
    end-to-end ``solve()`` latency exceeded the service's configured
    ``deadline_s`` (the real-time budget); a miss is an SLO violation,
    not an error -- the response is still returned and validated."""

    ticks: int = 0
    resets: int = 0
    last_latency_s: float = 0.0
    deadline_misses: int = 0

    def record_latency(self, seconds: float, deadline_s) -> None:
        self.last_latency_s = seconds
        self.ticks += 1
        if deadline_s is not None and seconds > deadline_s:
            self.deadline_misses += 1


class MPCService:
    """Warm-started batched MPC serving endpoint."""

    def __init__(
        self,
        qqp: QuantizedQP,
        batch: int,
        iters_per_tick: int = 15,
        use_fused: Optional[bool] = None,
        inputs_per_step: int = 1,
        g_on_device: bool = True,
        deadline_s: Optional[float] = LTI_BUDGET_S,
    ):
        """``inputs_per_step``: m of the underlying MPC problem; the warm
        -start shift moves one STEP (= m lanes) per tick.

        ``use_fused``: solve with the single-launch kernel
        (:class:`~pint_jax.mpc.fused.FusedPGD`, bit-identical to
        ``FixedPointPGD``); ``None`` selects it where its route compiles
        (a GPU) and it is measured to win.

        ``g_on_device`` (default): compute the fixed-point linear term g
        from the raw state batch on the device (f32 at full precision)
        inside the tick program, so one tick is a single dispatch from
        raw states.  ``False`` computes it with
        `QuantizedQP.g_lane_fixed`'s float64 numpy on the host, a
        per-tick host cost that grows with the batch.  f32 vs f64 can
        move int32 rounding ties, so the device path is a
        self-consistent sibling of the host path (same non-finite
        guards)."""
        from pint_jax.mpc.fused import FUSED_PGD_WINS, FusedPGD, route_compiles

        self.qqp = qqp
        self.batch = batch
        self.m = inputs_per_step
        self.deadline_s = deadline_s
        self.g_on_device = g_on_device
        if use_fused is None:
            use_fused = route_compiles() and FUSED_PGD_WINS
        if use_fused:
            self._solver = FusedPGD(qqp, iters=iters_per_tick)
        else:
            self._solver = FixedPointPGD(qqp, iters=iters_per_tick)
        self._warm = self._solver.init_words(batch)
        self._zero = self._solver.init_words(batch)
        self.stats = ServiceStats()

        m = self.m

        @jax.jit
        def tick(words, g_pre):
            words = self._solver.solve_words(words, g_pre)
            lanes = unpack_controls(words)[:, : qqp.horizon]
            # warm start for the next tick: plan shifted one step (m lanes)
            all_lanes = unpack_controls(words)
            shifted = jnp.concatenate(
                [all_lanes[:, m:], jnp.zeros_like(all_lanes[:, :m])],
                axis=-1,
            )
            from pint_jax.models.dynamics import pack_controls

            return words, pack_controls(shifted), lanes

        self._tick = tick

        # device-side linear term: g = x0 G^T + g_ref, scaled/rounded
        # with the same non-finite guards as QuantizedQP.g_lane_fixed
        GT = jnp.asarray(np.asarray(qqp.qp.G).T, jnp.float32)
        g_ref = jnp.asarray(np.asarray(qqp.qp.g_ref), jnp.float32)
        g_scale = jnp.float32(qqp.Gq_scale)
        pad = qqp.padded - qqp.horizon

        @jax.jit
        def tick_from_states(words, x0_f):
            g = jnp.dot(x0_f, GT, precision=jax.lax.Precision.HIGHEST) + g_ref
            g = jnp.nan_to_num(
                g * g_scale, nan=0.0,
                posinf=2.0**31 - 1, neginf=-(2.0**31),
            )
            gq = jnp.clip(
                jnp.round(g), -(2.0**31), 2.0**31 - 1
            ).astype(jnp.int32)
            if pad:
                gq = jnp.pad(gq, ((0, 0), (0, pad)))
            return tick(words, gq)

        self._tick_from_states = tick_from_states

    def solve(self, x0_phys: np.ndarray) -> np.ndarray:
        """One service tick: (batch, n) states -> (batch, T) physical
        controls.  Validates and self-heals the warm state."""
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        if x0.shape[0] != self.batch:
            raise ValueError(
                f"service compiled for batch {self.batch}, got {x0.shape[0]}"
            )
        t0 = time.perf_counter()
        if self.g_on_device:
            words, warm, lanes = self._tick_from_states(
                self._warm, jnp.asarray(x0, jnp.float32)
            )
        else:
            g_pre = jnp.asarray(self.qqp.g_lane_fixed(x0))
            words, warm, lanes = self._tick(self._warm, g_pre)
        lanes_np = np.asarray(lanes)
        self.stats.record_latency(time.perf_counter() - t0, self.deadline_s)

        # validation: int8 lane range is structurally guaranteed; NaNs are
        # impossible in integer arithmetic, so the checks guard against
        # host-side corruption of g (overflow in the linear term) instead
        bad = ~np.isfinite(x0).all(axis=-1)
        bad |= np.abs(lanes_np).max(axis=-1) > 127
        if bad.any():
            self.stats.resets += int(bad.sum())
            keep = jnp.asarray(~bad)[:, None]
            warm = jnp.where(keep, warm, self._zero)
            lanes_np = np.where(bad[:, None], 0, lanes_np)
        self._warm = warm
        return lanes_np.astype(np.float64) * self.qqp.u_scale

    def reset(self) -> None:
        self._warm = self._zero


class RTIService:
    """Persistent nonlinear MPC endpoint: warm-started real-time iterations
    of the on-device SQP (:class:`pint_jax.mpc.DeviceSQP`) per tick.

    The nonlinear counterpart of :class:`MPCService`: the service owns the
    compiled device program (rollout + linearize + condense + quantize +
    fixed-point PGD, one XLA executable) and the packed warm plans; each
    tick accepts plain numpy physical states and returns the first control
    of every re-optimized plan, then shifts the plans one step.

    Validation/self-healing matches MPCService: non-finite input rows get
    their warm plan reset and a zero control back (the device path's
    non-finite guard already prevents NaN poisoning; the reset stops a
    corrupted tick's plan from warm-starting the next one).
    """

    def __init__(self, sqp, batch: int,
                 deadline_s: Optional[float] = RTI_BUDGET_S):
        """``sqp``: a configured DeviceSQP; set its ``sqp_iters`` to the
        per-tick RTI count (1 for classic RTI).  ``deadline_s``: the
        real-time budget per tick (default 50 Hz); ticks over budget
        increment ``stats.deadline_misses``."""
        self.sqp = sqp
        self.batch = batch
        self.deadline_s = deadline_s
        self.m = sqp.n_ctrl
        self._zero = sqp.init_words(batch)
        self._warm = self._zero
        self.stats = ServiceStats()

        m, n_dec = self.m, sqp.n_dec

        @jax.jit
        def tick(words, x0_f):
            words = sqp._solve_jit(words, x0_f)
            lanes = unpack_controls(words)
            u0 = lanes[:, :m]
            shifted = jnp.concatenate(
                [lanes[:, m:n_dec], jnp.zeros_like(lanes[:, :m])], axis=-1
            )
            from pint_jax.models.dynamics import pack_controls

            return pack_controls(shifted), u0

        self._tick = tick

    def solve(self, x0_phys: np.ndarray) -> np.ndarray:
        """One tick: (batch, n) physical states -> (batch, m) physical
        first controls of the freshly re-optimized plans."""
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        if x0.shape[0] != self.batch:
            raise ValueError(
                f"service compiled for batch {self.batch}, got {x0.shape[0]}"
            )
        t0 = time.perf_counter()
        warm, u0 = self._tick(self._warm, jnp.asarray(x0, jnp.float32))
        u0_np = np.asarray(u0)
        self.stats.record_latency(time.perf_counter() - t0, self.deadline_s)

        bad = ~np.isfinite(x0).all(axis=-1)
        if bad.any():
            self.stats.resets += int(bad.sum())
            keep = jnp.asarray(~bad)[:, None]
            warm = jnp.where(keep, warm, self._zero)
            u0_np = np.where(bad[:, None], 0, u0_np)
        self._warm = warm
        return u0_np.astype(np.float64) * np.asarray(self.sqp._lane_scales)

    def reset(self) -> None:
        self._warm = self._zero


class ConstrainedRTIService:
    """Persistent STATE-CONSTRAINED nonlinear MPC endpoint: warm-started
    real-time iterations of the fully on-device constrained SQP
    (:class:`pint_jax.mpc.DeviceConstrainedSQP`) per tick.

    The warm state is the packed plan AND the integer multiplier plane;
    per tick both are shifted one step -- the plan by ``m`` lanes, the
    multipliers by one constraint-row block (rows keep their step-k
    meaning across the receding horizon, the same discipline as
    :class:`pint_jax.mpc.constrained.ConstrainedController`).  Validation
    and self-healing match :class:`RTIService`: non-finite input rows get
    plan and multipliers reset and a zero control back.
    """

    def __init__(self, csqp, batch: int,
                 deadline_s: Optional[float] = CRTI_BUDGET_S):
        """``csqp``: a configured DeviceConstrainedSQP; set its
        ``dev.sqp_iters`` to the per-tick RTI count (1 for classic RTI).
        ``deadline_s``: real-time budget per tick (default 50 Hz)."""
        self.csqp = csqp
        self.batch = batch
        self.deadline_s = deadline_s
        d = csqp.dev
        self.m = d.n_ctrl
        self._zero = csqp.init_words(batch)
        self._zero_lam = csqp.init_lam(batch)
        self._warm = self._zero
        self._warm_lam = self._zero_lam
        self.stats = ServiceStats()

        m, n_dec = self.m, d.n_dec
        Cs = csqp._F.shape[0]
        C = csqp.n_rows

        @jax.jit
        def tick(words, lam, x0_f):
            words, lam = csqp._solve_jit(words, x0_f, lam)
            lanes = unpack_controls(words)
            u0 = lanes[:, :m]
            shifted = jnp.concatenate(
                [lanes[:, m:n_dec], jnp.zeros_like(lanes[:, :m])], axis=-1
            )
            lam_shift = jnp.concatenate(
                [
                    lam[:, Cs:C],
                    jnp.zeros_like(lam[:, :Cs]),
                    lam[:, C:],  # inert padding rows stay zero
                ],
                axis=-1,
            )
            from pint_jax.models.dynamics import pack_controls

            return pack_controls(shifted), lam_shift, u0

        self._tick = tick

    def solve(self, x0_phys: np.ndarray) -> np.ndarray:
        """One tick: (batch, n) physical states -> (batch, m) physical
        first controls of the freshly re-optimized constrained plans."""
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        if x0.shape[0] != self.batch:
            raise ValueError(
                f"service compiled for batch {self.batch}, got {x0.shape[0]}"
            )
        t0 = time.perf_counter()
        warm, warm_lam, u0 = self._tick(
            self._warm, self._warm_lam, jnp.asarray(x0, jnp.float32)
        )
        u0_np = np.asarray(u0)
        self.stats.record_latency(time.perf_counter() - t0, self.deadline_s)

        bad = ~np.isfinite(x0).all(axis=-1)
        if bad.any():
            self.stats.resets += int(bad.sum())
            keep = jnp.asarray(~bad)[:, None]
            warm = jnp.where(keep, warm, self._zero)
            warm_lam = jnp.where(keep, warm_lam, self._zero_lam)
            u0_np = np.where(bad[:, None], 0, u0_np)
        self._warm = warm
        self._warm_lam = warm_lam
        return u0_np.astype(np.float64) * np.asarray(
            self.csqp.dev._lane_scales
        )

    def reset(self) -> None:
        self._warm = self._zero
        self._warm_lam = self._zero_lam
