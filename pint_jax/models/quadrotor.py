"""Planar quadrotor (birotor): 6-state, 2-input fixed-point dynamics.

The third model family: unlike the double integrator (linear, SISO) and the
unicycle (nonlinear, velocity-controlled), the birotor is nonlinear with
*coupled multi-input* control -- the model that exercises the multi-input
condensed QP (``condense_lti``) in closed loop.

State (all int32): x, y [Q16 m], theta [Q16 turns], vx, vy [Q16 m/s],
omega [Q16 turns/s].  Controls: two int8 rotor lanes, thrust deltas around
hover: f_i = f_hover + lane * 2^(f_shift - 16).

Continuous model (mass 1, quadratic trig s(t) ~ sin(2*pi*t)):

    ax = -(f1 + f2) * s(theta)
    ay =  (f1 + f2) * c(theta) - g
    domega = (f2 - f1) * 2^-torque_shift   (lever/inertia folded in)

discretized with Euler at dt = 2^-dt_shift; every multiply is a Q14-trig
product or a shift, as in the unicycle.

The hover linearization (:meth:`hover_lti`) uses the MODEL's trig slope
(the parabola's 8 per turn at zero, not the true 2*pi), so the condensed QP
is consistent with the plant it controls.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    _dsin_turns_f32,
    _dsin_turns_f64,
    _sin_turns_f32,
    _sin_turns_f64,
    _sin_turns_q14,
)

Array = jax.Array

__all__ = ["PlanarQuadrotor"]

_GRAVITY = 9.8125  # chosen so g_fp = round(g * 2^16) is exact-ish; Q16


@dataclasses.dataclass(frozen=True)
class PlanarQuadrotor:
    dt_shift: int = 5       # dt = 1/32 s
    frac_bits: int = 16
    f_shift: int = 9        # thrust delta per lane: 2^(9-16) = 1/128 N
    torque_shift: int = 4   # domega = (f2-f1) >> 4  [turns/s^2 per N]

    def __post_init__(self):
        if not (0 <= self.f_shift <= 11):
            # (total_fp >> 2) * trig_q14 must fit int32
            raise ValueError(f"f_shift={self.f_shift} out of range")

    @property
    def dt(self) -> float:
        return 2.0 ** (-self.dt_shift)

    @property
    def f_scale(self) -> float:
        """Thrust units per int8 lane."""
        return 2.0 ** (self.f_shift - self.frac_bits)

    @property
    def lane_scales(self) -> np.ndarray:
        """(2,) physical thrust-delta Newtons per int8 lane unit for the
        two rotor channels -- the generic-model hook the SQP tiers
        (QuantizedSQP / DeviceSQP / DeviceConstrainedSQP) consume."""
        return np.array([self.f_scale, self.f_scale])

    @property
    def hover_fp(self) -> int:
        """Per-rotor hover thrust, Q16 (total = g)."""
        return int(round(_GRAVITY * 2.0**self.frac_bits)) // 2

    @property
    def g_fp(self) -> int:
        return int(round(_GRAVITY * 2.0**self.frac_bits))

    # -- fixed-point step ----------------------------------------------------

    def step(self, state: Array, u1: Array, u2: Array) -> Array:
        """state: (..., 6) int32; u1, u2: (...) int32 lanes in [-128, 127]."""
        x, y, th = state[..., 0], state[..., 1], state[..., 2]
        vx, vy, om = state[..., 3], state[..., 4], state[..., 5]
        f1 = np.int32(self.hover_fp) + (u1 << self.f_shift)
        f2 = np.int32(self.hover_fp) + (u2 << self.f_shift)
        total = f1 + f2                      # Q16, <= 2^20.1 at f_shift=11
        s = _sin_turns_q14(th)
        c = _sin_turns_q14(th + (1 << 14))
        # (total>>4) <= 2^16.1; * Q14 <= 2^30.1 fits int32; >>10 -> Q16
        ax = -(((total >> 4) * s) >> 10)
        ay = (((total >> 4) * c) >> 10) - np.int32(self.g_fp)
        dom = (f2 - f1) >> self.torque_shift
        ds = self.dt_shift
        return jnp.stack(
            [
                x + (vx >> ds),
                y + (vy >> ds),
                th + (om >> ds),
                vx + (ax >> ds),
                vy + (ay >> ds),
                om + (dom >> ds),
            ],
            axis=-1,
        )

    def rollout(self, state0: Array, controls: Array) -> Array:
        """controls: (..., T, 2) int32 lanes.  Returns (..., T+1, 6)."""

        def body(carry, u_t):
            nxt = self.step(carry, u_t[..., 0], u_t[..., 1])
            return nxt, nxt

        controls_tfirst = jnp.moveaxis(controls, -2, 0)
        _, states = jax.lax.scan(body, state0, controls_tfirst)
        states = jnp.moveaxis(states, 0, -2)
        return jnp.concatenate([state0[..., None, :], states], axis=-2)

    # -- hover linearization for the condensed QP ---------------------------

    def hover_lti(self) -> Tuple[np.ndarray, np.ndarray]:
        """(A, B) of the Euler-discretized hover linearization, in PHYSICAL
        units (thrust deltas in Newtons; theta in turns).

        Consistent with the fixed-point plant: the trig slope at zero is the
        parabola's 8 per turn, and d(ay)/d(total) = 1.
        """
        dt = self.dt
        slope = 8.0  # d sin_turns / d t at 0 for the quadratic approx
        n = 6
        Ac = np.zeros((n, n))
        Ac[0, 3] = 1.0
        Ac[1, 4] = 1.0
        Ac[2, 5] = 1.0
        Ac[3, 2] = -_GRAVITY * slope
        Bc = np.zeros((n, 2))
        Bc[4, 0] = 1.0
        Bc[4, 1] = 1.0
        k = 2.0**-self.torque_shift * 2.0**0  # domega per Newton of (f2-f1)
        Bc[5, 0] = -k
        Bc[5, 1] = k
        A = np.eye(n) + dt * Ac
        B = dt * Bc
        return A, B

    # -- unit helpers --------------------------------------------------------

    def to_fixed(self, state_phys: np.ndarray) -> np.ndarray:
        s = np.asarray(state_phys, np.float64).copy()
        return np.round(s * 2.0**self.frac_bits).astype(np.int32)

    def to_float(self, state_fp) -> np.ndarray:
        return np.asarray(state_fp, np.float64) * 2.0**-self.frac_bits

    # -- float64 reference ---------------------------------------------------

    def reference_rollout(
        self, state0_f: np.ndarray, controls_f: np.ndarray
    ) -> np.ndarray:
        """float64 twin (same discrete map, same quadratic trig).
        controls_f: (..., T, 2) thrust deltas in Newtons."""
        from pint_jax.models.dynamics import _sin_turns_f64

        dt = self.dt
        st = np.asarray(state0_f, np.float64).copy()
        controls_f = np.asarray(controls_f, np.float64)
        T = controls_f.shape[-2]
        out = np.empty(st.shape[:-1] + (T + 1, 6), np.float64)
        out[..., 0, :] = st
        hover = self.hover_fp * 2.0**-self.frac_bits
        for k in range(T):
            x, y, th, vx, vy, om = (st[..., i] for i in range(6))
            f1 = hover + controls_f[..., k, 0]
            f2 = hover + controls_f[..., k, 1]
            total = f1 + f2
            s = _sin_turns_f64(th)
            c = _sin_turns_f64(th + 0.25)
            ax = -total * s
            ay = total * c - _GRAVITY
            dom = (f2 - f1) * 2.0**-self.torque_shift
            st = np.stack(
                [
                    x + vx * dt,
                    y + vy * dt,
                    th + om * dt,
                    vx + ax * dt,
                    vy + ay * dt,
                    om + dom * dt,
                ],
                axis=-1,
            )
            out[..., k + 1, :] = st
        return out

    # -- linearization (LTV/SQP hook) ----------------------------------------

    def linearize(
        self, states_f: np.ndarray, controls_f: np.ndarray
    ) -> tuple:
        """Exact Jacobians of the float64 discrete (explicit-Euler) map
        at (states_f, controls_f): states (..., 6), controls (..., 2)
        thrust deltas in Newtons -> (A (..., 6, 6), B (..., 6, 2)).

        Includes the quadratic trig's own derivative, so an LTV
        condensation built from these is the true local model of
        :meth:`reference_rollout`, not of an idealized smooth twin (same
        discipline as Unicycle.linearize, models/dynamics.py)."""
        states_f = np.asarray(states_f, np.float64)
        controls_f = np.asarray(controls_f, np.float64)
        th = states_f[..., 2]
        hover = self.hover_fp * 2.0**-self.frac_bits
        total = 2.0 * hover + controls_f[..., 0] + controls_f[..., 1]
        dt = self.dt
        s = _sin_turns_f64(th)
        c = _sin_turns_f64(th + 0.25)
        ds = _dsin_turns_f64(th)
        dc = _dsin_turns_f64(th + 0.25)
        k = 2.0**-self.torque_shift
        batch = states_f.shape[:-1]
        A = np.zeros(batch + (6, 6))
        for i in range(6):
            A[..., i, i] = 1.0
        A[..., 0, 3] = dt
        A[..., 1, 4] = dt
        A[..., 2, 5] = dt
        A[..., 3, 2] = -dt * total * ds
        A[..., 4, 2] = dt * total * dc
        B = np.zeros(batch + (6, 2))
        B[..., 3, 0] = -dt * s
        B[..., 3, 1] = -dt * s
        B[..., 4, 0] = dt * c
        B[..., 4, 1] = dt * c
        B[..., 5, 0] = -dt * k
        B[..., 5, 1] = dt * k
        return A, B

    # -- float32 jnp twins (device-resident SQP) -----------------------------

    def rollout_f32(self, state0_f: Array, controls_f: Array) -> Array:
        """jnp float32 rollout of the same explicit-Euler map (same
        quadratic trig, same quantized hover thrust).  state0_f (..., 6),
        controls_f (..., T, 2) thrust deltas -> (..., T+1, 6)."""
        dt = np.float32(self.dt)
        g = np.float32(_GRAVITY)
        hover2 = np.float32(2.0 * self.hover_fp * 2.0**-self.frac_bits)
        k = np.float32(2.0**-self.torque_shift)

        def body(carry, u_t):
            x, y, th = carry[..., 0], carry[..., 1], carry[..., 2]
            vx, vy, om = carry[..., 3], carry[..., 4], carry[..., 5]
            total = hover2 + u_t[..., 0] + u_t[..., 1]
            s = _sin_turns_f32(th)
            c = _sin_turns_f32(th + np.float32(0.25))
            ax = -total * s
            ay = total * c - g
            dom = (u_t[..., 1] - u_t[..., 0]) * k
            nxt = jnp.stack(
                [
                    x + vx * dt,
                    y + vy * dt,
                    th + om * dt,
                    vx + ax * dt,
                    vy + ay * dt,
                    om + dom * dt,
                ],
                axis=-1,
            )
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
        """jnp float32 twin of :meth:`linearize` (same analytic
        Jacobians), for the device-resident SQP.  n=6 exercises the
        pivot-free Gauss-Jordan inverse's largest claimed lane count
        (DeviceSQP._inv_unrolled, allpairs propagator)."""
        th = states_f[..., 2]
        dt = np.float32(self.dt)
        hover2 = np.float32(2.0 * self.hover_fp * 2.0**-self.frac_bits)
        total = hover2 + controls_f[..., 0] + controls_f[..., 1]
        s = _sin_turns_f32(th)
        c = _sin_turns_f32(th + np.float32(0.25))
        ds = _dsin_turns_f32(th)
        dc = _dsin_turns_f32(th + np.float32(0.25))
        k = np.float32(2.0**-self.torque_shift)
        z = jnp.zeros_like(th)
        one = jnp.ones_like(th)
        dtc = jnp.full_like(th, dt)
        A = jnp.stack(
            [
                jnp.stack([one, z, z, dtc, z, z], -1),
                jnp.stack([z, one, z, z, dtc, z], -1),
                jnp.stack([z, z, one, z, z, dtc], -1),
                jnp.stack([z, z, -dt * total * ds, one, z, z], -1),
                jnp.stack([z, z, dt * total * dc, z, one, z], -1),
                jnp.stack([z, z, z, z, z, one], -1),
            ],
            -2,
        )
        B = jnp.stack(
            [
                jnp.stack([z, z], -1),
                jnp.stack([z, z], -1),
                jnp.stack([z, z], -1),
                jnp.stack([-dt * s, -dt * s], -1),
                jnp.stack([dt * c, dt * c], -1),
                jnp.stack([jnp.full_like(th, -dt * k),
                           jnp.full_like(th, dt * k)], -1),
            ],
            -2,
        )
        return A, B
