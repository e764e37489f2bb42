"""Torque-limited pendulum: the classic underactuated swing-up family.

State (theta, omega): theta int32 Q16 **turns from upright** (wraps mod one
turn for free at the Q16 boundary, like the unicycle heading), omega int32
Q16 turns/s.  Control: a single int8 torque lane.  Continuous model
(phi = 2*pi*theta measured from upright, so gravity is destabilizing):

    phi'' = (g/l) sin(phi) + u / (m l^2)

in turns:  theta'' = k_g * sin_q(theta) + u_lane * u_scale, with
k_g = g / (2*pi*l) and the same quadratic sine as the unicycle
(:func:`pint_jax.models.dynamics._sin_turns_q14` -- shared with the float
references, so device-vs-reference differences measure quantization alone).

Discretization is semi-implicit Euler (standard for mechanical systems:
bounded energy drift), dt = 2**-dt_shift:

    omega' = omega + dt * (k_g * sin_q(theta) + u)
    theta' = theta + dt * omega'

With the default scales the torque ceiling 127*u_scale is **below** the
gravity torque k_g, so a swing-up from hanging cannot be done in one pull:
the planner must pump energy across swings -- the canonical second-order
planning problem the LTV/SQP solver (pint_jax.mpc.ltv) is tested on.

No counterpart in the reference library; this is BASELINE.json capability
surface (quantized dynamics rollouts with packed saturating controls).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    _dsin_turns_f32,
    _dsin_turns_f64,
    _sin_turns_f32,
    _sin_turns_f64,
    _sin_turns_q14,
    unpack_controls,
)

Array = jax.Array

__all__ = ["Pendulum"]


@dataclasses.dataclass(frozen=True)
class Pendulum:
    """Fixed-point torque-limited pendulum (theta in Q16 turns from
    upright)."""

    dt_shift: int = 5          # dt = 1/32 s
    k_g: float = 2.5           # gravity gain, turns/s^2 (= g / (2 pi l))
    u_shift: int = 9           # u = lane << u_shift, Q16 turns/s^2

    def __post_init__(self):
        if not (1 <= self.dt_shift <= 16):
            raise ValueError(f"dt_shift={self.dt_shift} out of range")
        if not (0 <= self.u_shift <= 20):
            raise ValueError(f"u_shift={self.u_shift} out of range")
        if not (0 < self.k_g < 8.0):
            # (kg_fp >> 2) * sin_q14 must fit int32: kg < 2^17 * 4 / 2^16
            raise ValueError(
                f"k_g={self.k_g}: the fixed-point gravity product needs "
                "0 < k_g < 8 turns/s^2 (rescale l instead)"
            )

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def u_scale(self) -> float:
        """Turns/s^2 of angular acceleration per int8 lane unit."""
        return 2.0 ** (self.u_shift - 16)

    @property
    def u_max(self) -> float:
        return 127.0 * self.u_scale

    @property
    def lane_scales(self) -> np.ndarray:
        """(1,) per-channel physical scale -- the generic-model hook the
        SQP solver consumes."""
        return np.array([self.u_scale])

    @property
    def _kg_fp(self) -> int:
        """k_g in Q16 turns/s^2, rounded to a multiple of 4 so the
        in-kernel ``>> 2`` headroom split is exact (the float references
        use the same quantized gain -- no systematic drift)."""
        return int(round(self.k_g * 16384.0)) << 2

    # -- fixed-point dynamics -------------------------------------------------

    def step(self, state: Array, u_lane: Array) -> Array:
        """One semi-implicit step.  state (..., 2) int32 [theta, omega];
        u_lane (...) int32 in [-128, 127]."""
        th, om = state[..., 0], state[..., 1]
        sin_q14 = _sin_turns_q14(th)
        # Q16 * Q14 >> 14 -> Q16; |k_g| < 8 turns/s^2 keeps the product
        # within int32 (kg_fp < 2^19, |sin| <= 2^14 -> < 2^33? no: product
        # < 2^19 * 2^14 = 2^33).  Split: (kg_fp >> 2) * sin >> 12.
        grav = ((self._kg_fp >> 2) * sin_q14) >> 12        # Q16 turns/s^2
        accel = grav + (u_lane << self.u_shift)
        om_next = om + (accel >> self.dt_shift)
        th_next = th + (om_next >> self.dt_shift)
        return jnp.stack([th_next, om_next], axis=-1)

    def rollout(self, state0: Array, controls: Array) -> Array:
        """controls (..., T) int32 lanes.  Returns (..., T+1, 2)."""

        def body(carry, u_t):
            nxt = self.step(carry, u_t)
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(controls, -1, 0)
        _, states = jax.lax.scan(body, state0, controls_tfirst)
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0[..., None, :], states], axis=-2)

    def rollout_packed(self, state0: Array, control_words: Array) -> Array:
        return self.rollout(state0, unpack_controls(control_words))

    # -- float64 reference (same discrete map, same quadratic trig) -----------

    def reference_rollout(
        self, state0_f: np.ndarray, controls_f: np.ndarray
    ) -> np.ndarray:
        """controls_f (..., T, 1) physical turns/s^2; state (..., 2)
        [theta-in-turns, omega]."""
        dt = self.dt
        state0_f = np.asarray(state0_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        T = controls_f.shape[-2]
        out = np.empty(state0_f.shape[:-1] + (T + 1, 2), np.float64)
        out[..., 0, :] = state0_f
        th = state0_f[..., 0].copy()
        om = state0_f[..., 1].copy()
        kg = self._kg_fp * 2.0**-16  # the quantized gain, not self.k_g
        for k in range(T):
            om = om + dt * (kg * _sin_turns_f64(th) + controls_f[..., k, 0])
            th = th + dt * om
            out[..., k + 1, 0], out[..., k + 1, 1] = th, om
        return out

    # -- linearization (LTV/SQP hook) ------------------------------------------

    def linearize(
        self, states_f: np.ndarray, controls_f: np.ndarray
    ) -> tuple:
        """Exact Jacobians of the float64 discrete map.

        Semi-implicit chain: om' = om + dt(kg sin(th) + u), th' = th + dt om'
        => d th'/d th = 1 + dt^2 kg dsin, d th'/d om = dt, d th'/du = dt^2.
        """
        states_f = np.asarray(states_f, np.float64)
        th = states_f[..., 0]
        dt = self.dt
        kg = self._kg_fp * 2.0**-16
        ds = kg * _dsin_turns_f64(th)
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (2, 2))
        A[..., 0, 0] = 1.0 + dt * dt * ds
        A[..., 0, 1] = dt
        A[..., 1, 0] = dt * ds
        A[..., 1, 1] = 1.0
        B = np.zeros(batch + (2, 1))
        B[..., 0, 0] = dt * dt
        B[..., 1, 0] = dt
        return A, B

    # -- float32 jnp twins (device-resident SQP) -------------------------------

    def rollout_f32(self, state0_f: Array, controls_f: Array) -> Array:
        """jnp float32 rollout of the same semi-implicit map (same quantized
        gain, same quadratic trig).  state0_f (..., 2), controls_f
        (..., T, 1) -> (..., T+1, 2)."""
        dt = np.float32(self.dt)
        kg = np.float32(self._kg_fp * 2.0**-16)

        def body(carry, u_t):
            th, om = carry[..., 0], carry[..., 1]
            om = om + dt * (kg * _sin_turns_f32(th) + u_t[..., 0])
            th = th + dt * om
            nxt = jnp.stack([th, om], axis=-1)
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(
            controls_f.astype(jnp.float32), -2, 0
        )
        _, states = jax.lax.scan(
            body, state0_f.astype(jnp.float32), controls_tfirst
        )
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0_f[..., None, :], states], axis=-2)

    def linearize_f32(self, states_f: Array, controls_f: Array) -> tuple:
        """jnp float32 twin of :meth:`linearize`."""
        th = states_f[..., 0]
        dt = np.float32(self.dt)
        kg = np.float32(self._kg_fp * 2.0**-16)
        ds = kg * _dsin_turns_f32(th)
        one = jnp.ones_like(th)
        A = jnp.stack(
            [
                jnp.stack([one + dt * dt * ds, jnp.full_like(th, dt)], -1),
                jnp.stack([dt * ds, one], -1),
            ],
            -2,
        )
        B = jnp.stack(
            [
                jnp.full_like(th, dt * dt)[..., None],
                jnp.full_like(th, dt)[..., None],
            ],
            -2,
        )
        return A, B

    # -- unit conversion --------------------------------------------------------

    def to_fixed(self, x: np.ndarray) -> np.ndarray:
        return np.round(np.asarray(x) * 65536.0).astype(np.int32)

    def to_float(self, x) -> np.ndarray:
        return np.asarray(x, np.float64) * 2.0**-16
