"""Quantized discrete-time dynamics models (fixed-point, batched in JAX).

These models have no counterpart in the reference library (which defines only
the SWAR arithmetic substrate, pint.hpp:758-1031); they are the rollout layer
of the BASELINE.json capability spec: batched quantized rollouts of a
discretized double integrator and unicycle, with int8 controls carried in
packed SWAR words.

Design rules (all chosen for the XLA compilation model):

* **All state arithmetic is int32 Q-format** (``frac_bits`` fractional bits).
  ``dt`` is a power of two (``2**-dt_shift``), so multiply-by-dt is an exact
  arithmetic shift -- no int64 intermediates, no rescaling rounding.
* **Controls are int8 lanes packed 4-per-uint32** with the
  ``PackedLayout(8,8,8,8)`` layout; the saturating packed control update
  (``add_signed_saturate``) IS the box projection onto the int8 range.
* **Rollouts are `lax.scan` over the horizon, vmapped/sharded over the
  batch** -- static shapes, no data-dependent control flow, XLA-fusable.
* The float64 reference implements the *same* discretization (including the
  quadratic trig approximation of the unicycle), so device-vs-reference
  differences measure quantization alone.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.layout import PackedLayout
from pint_jax.ops import word as W

Array = jax.Array

CONTROL_LAYOUT = PackedLayout(8, 8, 8, 8)  # 4 int8 control lanes per uint32

__all__ = [
    "CONTROL_LAYOUT",
    "DoubleIntegrator",
    "Unicycle",
    "pack_controls",
    "unpack_controls",
]


def pack_controls(controls: Array, layout: PackedLayout = CONTROL_LAYOUT) -> Array:
    """(..., T) int control lanes -> (..., T/k) packed words (k lanes/word).

    T must be a multiple of the layout's lane count.  Lane k of word j holds
    control step k_lanes*j + k.  The default layout is 4x int8 per uint32;
    any uniform layout works -- e.g. ``PackedLayout(*([4]*8))`` stores int4
    plans at 8 steps per word (there is no native sub-byte dtype; SWAR
    packing is the only way to get that density).
    """
    k = layout.num_lanes
    t = controls.shape[-1]
    if t % k:
        raise ValueError(
            f"control horizon {t} must be a multiple of {k} lanes"
        )
    lanes = controls.reshape(*controls.shape[:-1], t // k, k)
    return W.pack(layout, lanes.astype(jnp.int32))


def unpack_controls(words: Array, layout: PackedLayout = CONTROL_LAYOUT) -> Array:
    """(..., T/k) packed words -> (..., T) int32 sign-extended lanes."""
    lanes = W.unpack_signed(layout, words)  # (..., T/k, k) int32
    return lanes.reshape(
        *words.shape[:-1], words.shape[-1] * layout.num_lanes
    )


@dataclasses.dataclass(frozen=True)
class DoubleIntegrator:
    """1-D double integrator, exactly discretized, fixed-point.

    Continuous: p' = v, v' = u.  Discrete (dt = 2**-dt_shift):

        p[k+1] = p[k] + v[k]*dt + u[k]*dt^2/2
        v[k+1] = v[k] + u[k]*dt

    State (p, v) is int32 Q``frac_bits``; control lanes are int8 scaled by
    ``2**u_shift`` into Q``frac_bits`` acceleration units.
    """

    dt_shift: int = 5      # dt = 1/32 s
    frac_bits: int = 16    # Q16 states
    u_shift: int = 8       # u_fp = lane << 8  (accel in Q16: lane * 2^-8 units)

    def __post_init__(self):
        if not (0 <= self.u_shift <= 23):
            raise ValueError(
                f"u_shift={self.u_shift}: lane<<u_shift must fit int32"
            )
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def u_scale(self) -> float:
        """Physical acceleration units per int8 control step."""
        return 2.0 ** (self.u_shift - self.frac_bits)

    def step(self, state: Array, u_lane: Array) -> Array:
        """One fixed-point step.  state: (..., 2) int32; u_lane: (...) int32
        in [-128, 127]."""
        p, v = state[..., 0], state[..., 1]
        u_fp = u_lane << self.u_shift
        # v*dt and u*dt are arithmetic shifts (exact halvings, trunc to -inf)
        p_next = p + (v >> self.dt_shift) + (u_fp >> (2 * self.dt_shift + 1))
        v_next = v + (u_fp >> self.dt_shift)
        return jnp.stack([p_next, v_next], axis=-1)

    def rollout(self, state0: Array, controls: Array) -> Array:
        """Scan the horizon.  state0: (..., 2) int32; controls: (..., T)
        int32 lanes.  Returns states: (..., T+1, 2)."""

        def body(carry, u_t):
            nxt = self.step(carry, u_t)
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(controls, -1, 0)
        _, states = jax.lax.scan(body, state0, controls_tfirst)
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0[..., None, :], states], axis=-2)

    def rollout_packed(self, state0: Array, control_words: Array) -> Array:
        """Rollout directly from packed control words (..., T/4)."""
        return self.rollout(state0, unpack_controls(control_words))

    # -- float64 reference (same discretization) ---------------------------

    def reference_rollout(
        self, state0_f: np.ndarray, controls_f: np.ndarray
    ) -> np.ndarray:
        """float64 rollout of the same discrete map; controls in physical
        units (lane * u_scale)."""
        dt = self.dt
        state0_f = np.asarray(state0_f, dtype=np.float64)
        controls_f = np.asarray(controls_f, dtype=np.float64)
        T = controls_f.shape[-1]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 2), dtype=np.float64)
        out[..., 0, :] = state0_f
        p, v = state0_f[..., 0].copy(), state0_f[..., 1].copy()
        for k in range(T):
            u = controls_f[..., k]
            p = p + v * dt + 0.5 * u * dt * dt
            v = v + u * dt
            out[..., k + 1, 0], out[..., k + 1, 1] = p, v
        return out

    def to_fixed(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 2.0**self.frac_bits).astype(np.int32)

    def to_float(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * 2.0**-self.frac_bits


# -- fixed-point quadratic trig --------------------------------------------
#
# Angle convention: int32 Q16 *turns* (1.0 turn = full circle), which wraps
# for free mod 2**16.  cos/sin return Q14 in [-1, 1].  The approximation is
# the piecewise parabola sin(2*pi*t) ~ 16t(0.5-|t|)/(5-16|t|(0.5-|t|))-free
# simplified Bhaskara-like quadratic used identically by the float reference.


def _sin_turns_q14(theta_q16: Array) -> Array:
    """sin(2*pi*theta) for theta in Q16 turns -> Q14 result.

    Quadratic approximation: on t in [0, 0.5), sin ~ 8t(0.5 - t)*2 scaled;
    odd-extended to [0.5, 1).  Max abs error ~5.6e-2 (shared with the
    float64 reference, so it cancels in accuracy checks).
    """
    t = theta_q16 & 0xFFFF  # wrap to [0, 1) turns, Q16
    half = t & 0x7FFF       # position within half-turn, Q16 in [0, 0.5)
    # parabola half*(2^15 - half): peak 2^28 at quarter turn, fits int32;
    # >> 14 normalizes the peak to Q14 one (matches 16*h*(0.5-h) exactly)
    p = half * (0x8000 - half)
    val = p >> 14
    sign = ((t >> 15) & 1).astype(jnp.int32)  # 1 in second half-turn
    return jnp.where(sign == 1, -val, val)


def _sin_turns_f64(theta_turns: np.ndarray) -> np.ndarray:
    """float64 twin of :func:`_sin_turns_q14` (same parabola)."""
    t = np.mod(theta_turns, 1.0)
    half = np.mod(t, 0.5)
    val = 16.0 * half * (0.5 - half)  # peak 1.0 at quarter turn
    return np.where(t >= 0.5, -val, val)


def _dsin_turns_f64(theta_turns: np.ndarray) -> np.ndarray:
    """d/dtheta of :func:`_sin_turns_f64` (piecewise-linear, f64)."""
    t = np.mod(theta_turns, 1.0)
    half = np.mod(t, 0.5)
    dval = 16.0 * (0.5 - 2.0 * half)
    return np.where(t >= 0.5, -dval, dval)


def _dsin_turns_f32(theta_turns: Array) -> Array:
    """Differentiable jnp twin of :func:`_dsin_turns_f64`."""
    t = jnp.mod(theta_turns, 1.0)
    half = jnp.mod(t, 0.5)
    dval = 16.0 * (0.5 - 2.0 * half)
    return jnp.where(t >= 0.5, -dval, dval)


def _sin_turns_f32(theta_turns: Array) -> Array:
    """Differentiable jnp twin of the quadratic sine (same parabola).

    Piecewise-smooth (C^0 with kinks at half-turn boundaries), which is fine
    for gradient-based planning: jnp.where picks one branch's gradient.
    """
    t = jnp.mod(theta_turns, 1.0)
    half = jnp.mod(t, 0.5)
    val = 16.0 * half * (0.5 - half)
    return jnp.where(t >= 0.5, -val, val)


@dataclasses.dataclass(frozen=True)
class Unicycle:
    """Planar unicycle, fixed-point, with quadratic trig.

    State (x, y, theta): x,y int32 Q``frac_bits``; theta int32 Q16 turns.
    Controls per step: (v_lane, w_lane) int8; two (v, w) pairs pack into one
    uint32 word.  Discretization (dt = 2**-dt_shift):

        x' = x + v*cos(theta)*dt,  y' = y + v*sin(theta)*dt
        theta' = theta + w*dt
    """

    dt_shift: int = 5
    frac_bits: int = 16
    v_shift: int = 8       # v_fp = lane << v_shift  (Q16 speed)
    w_shift: int = 6       # w_fp = lane << w_shift  (Q16 turns/s)

    def __post_init__(self):
        # (v_fp >> 2) * cos_q14 must fit int32: |lane|<<v_shift <= 2^17
        if not (0 <= self.v_shift <= 10):
            raise ValueError(
                f"v_shift={self.v_shift}: (lane<<v_shift>>2)*Q14 must fit int32"
            )
        if not (0 <= self.w_shift <= 23):
            raise ValueError(f"w_shift={self.w_shift} out of range")
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def v_scale(self) -> float:
        return 2.0 ** (self.v_shift - self.frac_bits)

    @property
    def w_scale(self) -> float:
        return 2.0 ** (self.w_shift - self.frac_bits)

    @property
    def lane_scales(self) -> np.ndarray:
        """(2,) physical units per int8 lane for (v, w) -- the generic-model
        hook the LTV/SQP solver consumes."""
        return np.array([self.v_scale, self.w_scale])

    def step(self, state: Array, v_lane: Array, w_lane: Array) -> Array:
        x, y, th = state[..., 0], state[..., 1], state[..., 2]
        v_fp = v_lane << self.v_shift                  # Q16
        cos_q14 = _sin_turns_q14(th + (1 << 14))       # cos = sin(t + 1/4)
        sin_q14 = _sin_turns_q14(th)
        # v (Q16, |v|<2^15) * trig (Q14) -> Q30 >> 14 -> Q16; fits int32
        vx = ((v_fp >> 2) * cos_q14) >> 12
        vy = ((v_fp >> 2) * sin_q14) >> 12
        x_next = x + (vx >> self.dt_shift)
        y_next = y + (vy >> self.dt_shift)
        th_next = th + ((w_lane << self.w_shift) >> self.dt_shift)
        return jnp.stack([x_next, y_next, th_next], axis=-1)

    def rollout(self, state0: Array, controls: Array) -> Array:
        """controls: (..., T, 2) int32 lanes [(v, w) per step].
        Returns (..., T+1, 3)."""

        def body(carry, u_t):
            nxt = self.step(carry, u_t[..., 0], u_t[..., 1])
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(controls, -2, 0)
        _, states = jax.lax.scan(body, state0, controls_tfirst)
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0[..., None, :], states], axis=-2)

    def rollout_packed(self, state0: Array, control_words: Array) -> Array:
        """control_words: (..., T/2) uint32, two (v, w) pairs per word."""
        lanes = unpack_controls(control_words)  # (..., 2T)
        ctrl = lanes.reshape(*lanes.shape[:-1], lanes.shape[-1] // 2, 2)
        return self.rollout(state0, ctrl)

    # -- float32 differentiable twin ----------------------------------------

    def rollout_f32(self, state0_f: Array, controls_f: Array) -> Array:
        """Differentiable float32 rollout of the same discrete map.

        state0_f: (..., 3) float32 [x, y, theta-in-turns], physical units;
        controls_f: (..., T, 2) physical units.  Gradients through this twin
        drive the quantization-aware nonlinear solver
        (pint_jax.mpc.nonlinear); the quantized integer rollout remains the
        ground truth it is evaluated against.
        """
        dt = np.float32(self.dt)

        def body(carry, u_t):
            x, y, th = carry[..., 0], carry[..., 1], carry[..., 2]
            v, w = u_t[..., 0], u_t[..., 1]
            x = x + v * _sin_turns_f32(th + 0.25) * dt
            y = y + v * _sin_turns_f32(th) * dt
            th = th + w * dt
            nxt = jnp.stack([x, y, th], axis=-1)
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(controls_f, -2, 0)
        _, states = jax.lax.scan(body, state0_f.astype(jnp.float32),
                                 controls_tfirst.astype(jnp.float32))
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0_f[..., None, :], states], axis=-2)

    # -- float64 reference --------------------------------------------------

    def reference_rollout(
        self, state0_f: np.ndarray, controls_f: np.ndarray
    ) -> np.ndarray:
        """float64 rollout of the same discrete map with the same quadratic
        trig.  controls_f: (..., T, 2) physical units; theta in turns."""
        dt = self.dt
        state0_f = np.asarray(state0_f, dtype=np.float64)
        controls_f = np.asarray(controls_f, dtype=np.float64)
        T = controls_f.shape[-2]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 3), dtype=np.float64)
        out[..., 0, :] = state0_f
        x = state0_f[..., 0].copy()
        y = state0_f[..., 1].copy()
        th = state0_f[..., 2].copy()
        for k in range(T):
            v = controls_f[..., k, 0]
            w = controls_f[..., k, 1]
            x = x + v * _sin_turns_f64(th + 0.25) * dt
            y = y + v * _sin_turns_f64(th) * dt
            th = th + w * dt
            out[..., k + 1, 0], out[..., k + 1, 1], out[..., k + 1, 2] = x, y, th
        return out

    # -- linearization (the LTV/SQP inner-QP ingredient) ---------------------

    def linearize(
        self, states_f: np.ndarray, controls_f: np.ndarray
    ) -> tuple:
        """Jacobians of the float64 discrete map at (states_f, controls_f).

        states_f (..., 3) [x, y, theta-in-turns] and controls_f (..., 2)
        [v, w], physical units.  Returns (A, B) with A (..., 3, 3) and
        B (..., 3, 2) -- the exact derivatives of
        :meth:`reference_rollout`'s step (including the quadratic trig), so
        an LTV condensation built from them is the true local model of the
        reference dynamics, not of an idealized smooth twin.
        """
        states_f = np.asarray(states_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        th = states_f[..., 2]
        v = controls_f[..., 0]
        dt = self.dt
        cos_q = _sin_turns_f64(th + 0.25)
        sin_q = _sin_turns_f64(th)
        dcos = _dsin_turns_f64(th + 0.25)
        dsin = _dsin_turns_f64(th)
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (3, 3))
        A[..., 0, 0] = 1.0
        A[..., 1, 1] = 1.0
        A[..., 2, 2] = 1.0
        A[..., 0, 2] = v * dcos * dt
        A[..., 1, 2] = v * dsin * dt
        B = np.zeros(batch + (3, 2))
        B[..., 0, 0] = cos_q * dt
        B[..., 1, 0] = sin_q * dt
        B[..., 2, 1] = dt
        return A, B

    def linearize_f32(self, states_f: Array, controls_f: Array) -> tuple:
        """jnp float32 twin of :meth:`linearize` (same analytic Jacobians),
        for the device-resident SQP.  states_f (..., 3), controls_f
        (..., 2) -> (A (..., 3, 3), B (..., 3, 2))."""
        th = states_f[..., 2]
        v = controls_f[..., 0]
        dt = np.float32(self.dt)
        cos_q = _sin_turns_f32(th + 0.25)
        sin_q = _sin_turns_f32(th)
        dcos = _dsin_turns_f32(th + 0.25)
        dsin = _dsin_turns_f32(th)
        z = jnp.zeros_like(th)
        one = jnp.ones_like(th)
        A = jnp.stack(
            [
                jnp.stack([one, z, v * dcos * dt], -1),
                jnp.stack([z, one, v * dsin * dt], -1),
                jnp.stack([z, z, one], -1),
            ],
            -2,
        )
        B = jnp.stack(
            [
                jnp.stack([cos_q * dt, z], -1),
                jnp.stack([sin_q * dt, z], -1),
                jnp.stack([z, jnp.full_like(th, dt)], -1),
            ],
            -2,
        )
        return A, B

    def to_fixed_xy(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 2.0**self.frac_bits).astype(np.int32)

    def to_fixed_theta(self, t: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(t) * 2.0**16).astype(np.int32)

    def to_fixed(self, state_f: np.ndarray) -> np.ndarray:
        """Whole-state (..., 3) conversion (xy Q`frac_bits`, theta Q16)."""
        state_f = np.asarray(state_f, np.float64)
        return np.concatenate(
            [
                self.to_fixed_xy(state_f[..., :2]),
                self.to_fixed_theta(state_f[..., 2:]),
            ],
            axis=-1,
        )

    def to_float(self, state_fp) -> np.ndarray:
        """Whole-state inverse of :meth:`to_fixed`."""
        state_fp = np.asarray(state_fp)
        return np.concatenate(
            [
                self.to_float_xy(state_fp[..., :2]),
                self.to_float_theta(state_fp[..., 2:]),
            ],
            axis=-1,
        )

    def to_float_xy(self, x) -> np.ndarray:
        return np.asarray(x, dtype=np.float64) * 2.0**-self.frac_bits

    def to_float_theta(self, t) -> np.ndarray:
        return np.asarray(t, dtype=np.float64) * 2.0**-16
