"""Quantized LTV/SQP MPC: second-order nonlinear planning on packed int8 plans.

The sequential-quadratic-programming complement to the first-order
:mod:`pint_jax.mpc.nonlinear` solver.  Each outer (SQP) iteration:

1. rolls the current plan through the float64 reference dynamics (host),
2. linearizes the *exact* discrete map along that trajectory
   (:meth:`Unicycle.linearize` -- true Jacobians of the quadratic-trig map),
3. condenses the resulting time-varying affine QP in **absolute controls**
   (:func:`pint_jax.mpc.condensed.condense_ltv`), so the control box stays
   symmetric and maps onto int8 lane saturation exactly as in the LTI path,
4. quantizes (per problem) and solves the QP **on device** with the same
   fixed-point PGD iteration as :class:`FixedPointPGD` -- int8 matmul +
   saturating packed updates -- warm-started from the current packed plan.

Because every problem in the batch linearizes around its own trajectory,
the Hessian is per-problem: the device kernel is a *batched* int8
``dot_general`` (B, Tp) x (B, Tp, Tp) with per-problem int32 step rationals
(hs_num, hs_den) carried as runtime operands.  One XLA program serves all
SQP iterations (the operands change, the shapes don't), so outer iterations
cost zero recompiles -- the real-time-iteration property.

Decision units: the QP decision vector IS the int8 lane value (per-channel
physical scales are folded into the B columns and R), so u_max = 127 and
lane saturation is the exact box projection.

No counterpart in the reference library (SURVEY.md section 2.4): this is
BASELINE.json capability layer.  The packed-word machinery it exercises:
add_signed_saturate (pint.hpp:857-866), max_signed (pint.hpp:987-1004),
pack/unpack (pint.hpp:390-407, 799-822).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models.dynamics import (
    CONTROL_LAYOUT,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_jax.mpc.condensed import condense_ltv, condense_ltv_batch
from pint_jax.ops import word as W

Array = jax.Array

__all__ = ["QuantizedSQP", "SQPController"]


def _lower_words() -> np.uint32:
    w = 0
    for off in CONTROL_LAYOUT.offsets:
        w |= (-127 & 0xFF) << off
    return np.uint32(w)


def quantize_batch(
    H: np.ndarray,
    G: np.ndarray,
    g_ref: np.ndarray,
    alpha: np.ndarray,
    x0_f: np.ndarray,
    Tp: int,
    g_shift: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized per-problem :func:`pint_jax.mpc.condensed.quantize` in
    lane units (u_scale = 1, u_max = 127): the SQP inner-QP quantizer.

    ``alpha`` (B,) is the PGD step per problem -- 1/lip for the plain SQP,
    1/(lip + rho * penalty_lip) for the state-constrained variant.  Returns
    (Hq (B,Tp,Tp) int8, g_pre (B,Tp) int32, hs_num (B,), hs_den (B,)).
    """
    batch = H.shape[0]
    aH = alpha[:, None, None] * H
    h_scale = np.abs(aH).max(axis=(1, 2)) / 127.0       # (B,)
    Hq = np.zeros((batch, Tp, Tp), np.int8)
    Hq[:, : H.shape[1], : H.shape[2]] = np.round(
        aH / h_scale[:, None, None]
    ).astype(np.int8)
    g = np.einsum("bin,bn->bi", G, x0_f) + g_ref        # (B, Tm)
    gq = np.round(
        np.nan_to_num(
            g * (alpha * float(2**g_shift))[:, None],
            posinf=2**31 - 1, neginf=-(2**31),
        )
    )
    g_pre = np.zeros((batch, Tp), np.int32)
    g_pre[:, : g.shape[1]] = np.clip(gq, -(2**31), 2**31 - 1).astype(
        np.int32
    )
    val = h_scale * float(2**g_shift)                   # (B,)
    num_max = (2**31 - 1) // (127 * 127 * Tp)
    hs_den = np.clip(
        np.floor(np.log2(num_max / val)), 0, 31
    ).astype(np.int32)
    hs_num = np.round(val * 2.0**hs_den).astype(np.int64)
    if (hs_num < 1).any() or (hs_num > num_max).any():
        raise ValueError(
            "step scale cannot be represented as an int32 rational "
            "(degenerate problem scaling); rescale Q/R or g_shift"
        )
    return Hq, g_pre, hs_num.astype(np.int32), hs_den


@functools.partial(jax.jit, static_argnames=("iters", "g_shift"))
def _pgd_batched_h(
    u_words: Array,   # (B, Tp/4) uint32 packed int8 lanes
    g_pre: Array,     # (B, Tp) int32 pre-shift lane units
    Hq: Array,        # (B, Tp, Tp) int8 per-problem quantized Hessian
    hs_num: Array,    # (B,) int32
    hs_den: Array,    # (B,) int32
    *,
    iters: int,
    g_shift: int,
) -> Array:
    """Fixed-point PGD with a per-problem Hessian (the SQP inner solve).

    Identical iteration to FixedPointPGD._iterate_ef except the matmul is
    batched over problems and the step rational is a runtime operand.
    Error feedback is always on here: SQP progress near convergence (and in
    weakly-weighted directions like heading) rides on sub-lane step
    components, which plain rounding would freeze at the first iterate.
    """
    lower = jnp.full((1,), _lower_words(), jnp.uint32)
    half = np.int32(1 << (g_shift - 1))

    def body(_, state):
        words, carry = state
        lanes = unpack_controls(words)  # (B, Tp) int32
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            Hq,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, Tp) = sum_t U_t Hq[s, t]
        pre = (acc * hs_num[:, None]) >> hs_den[:, None]
        step = -(pre + g_pre) + carry
        delta = jnp.clip((step + half) >> np.int32(g_shift), -128, 127)
        carry = step - (delta << np.int32(g_shift))
        words = W.add_signed_saturate(
            CONTROL_LAYOUT, words, pack_controls(delta)
        )
        words = W.max_signed(
            CONTROL_LAYOUT, words, jnp.broadcast_to(lower, words.shape)
        )
        return words, carry

    # derive the zero carry from g_pre so its device-varying axes match the
    # loop output under shard_map (a bare jnp.zeros would be replicated)
    carry0 = g_pre ^ g_pre
    words, _ = jax.lax.fori_loop(0, iters, body, (u_words, carry0))
    return words


def _pgd_cols_loop(
    u_words: Array,   # (B, block/4) uint32: this rank's iterate columns
    g_r: Array,       # (B, block) int32: this rank's linear-term columns
    hs_num: Array,
    hs_den: Array,
    acc_of,           # lanes (B, block) -> (B, block) reduced accumulator
    *,
    iters: int,
    g_shift: int,
) -> Array:
    """Column-sharded PGD iteration: ``acc_of`` supplies this rank's
    psum-reduced raw int32 gradient accumulator block; the loop applies
    step scaling, error feedback and the saturating packed update."""
    lower = jnp.full((1,), _lower_words(), jnp.uint32)
    half = np.int32(1 << (g_shift - 1))

    def body(_, state):
        words, carry = state
        lanes = unpack_controls(words)  # (B, block) int32
        acc_blk = acc_of(lanes)
        pre = (acc_blk * hs_num[:, None]) >> hs_den[:, None]
        step = -(pre + g_r) + carry
        delta = jnp.clip((step + half) >> np.int32(g_shift), -128, 127)
        carry = step - (delta << np.int32(g_shift))
        words = W.add_signed_saturate(
            CONTROL_LAYOUT, words, pack_controls(delta)
        )
        words = W.max_signed(
            CONTROL_LAYOUT, words, jnp.broadcast_to(lower, words.shape)
        )
        return words, carry

    carry0 = g_r ^ g_r
    words, _ = jax.lax.fori_loop(0, iters, body, (u_words, carry0))
    return words


def _pgd_batched_h_cols(
    u_words: Array,   # (B, block/4) uint32: this rank's iterate columns
    g_r: Array,       # (B, block) int32: this rank's linear-term columns
    Hq: Array,        # (B, Tp, Tp) int8 per-problem Hessian (tp-replicated)
    hs_num: Array,    # (B,) int32
    hs_den: Array,    # (B,) int32
    *,
    iters: int,
    g_shift: int,
    axis_name: str,
    block: int,
) -> Array:
    """Column-sharded :func:`_pgd_batched_h`: the horizon splits into
    ``block``-wide column blocks across mesh axis ``axis_name``.

    Each iteration this rank contributes ``U_r @ Hq[:, :, cols_r]^T`` to an
    exact int32 psum of the full gradient, then updates only its own
    columns.  Wrapping int32 addition is associative, so the result is
    bit-identical to the single-device `_pgd_batched_h` restricted to this
    rank's columns (tests/test_device_sqp.py)."""
    r = jax.lax.axis_index(axis_name)
    Hq_cols = jax.lax.dynamic_slice_in_dim(Hq, r * block, block, axis=2)

    def acc_of(lanes):
        partial = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            Hq_cols,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, Tp) = our columns' contribution to every gradient row
        acc = jax.lax.psum(partial, axis_name)
        return jax.lax.dynamic_slice_in_dim(acc, r * block, block, axis=1)

    return _pgd_cols_loop(
        u_words, g_r, hs_num, hs_den, acc_of,
        iters=iters, g_shift=g_shift,
    )



@dataclasses.dataclass(frozen=True)
class QuantizedSQP:
    """SQP trajectory optimizer on packed int8 plans, for any model exposing
    ``reference_rollout(x0, u_phys)``, ``linearize(states, controls)`` and
    ``lane_scales`` (Unicycle, Pendulum, ...).

    Cost: sum_{k=1..T} (x_k - x_ref_k)^T Q (x_k - x_ref_k) (terminal Qf at
    x_T) + sum_k u_k^T R u_k with u in physical units and the per-channel
    box |u_c| <= 127 * lane_scales[c] (the int8 lane range).  Q and R must
    match the model's state/control dims (defaults fit the unicycle).
    """

    model: object = dataclasses.field(default_factory=Unicycle)
    horizon: int = 48
    Q: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([1.0, 1.0, 0.02])
    )
    R: np.ndarray = dataclasses.field(
        default_factory=lambda: np.diag([0.02, 0.02])
    )
    qf_scale: float = 20.0
    Qf: Optional[np.ndarray] = None
    """Explicit terminal weight; overrides ``qf_scale * Q`` when given.
    Pass :func:`pint_jax.mpc.condensed.dare_terminal` of the linearization
    at the operating point to inherit the infinite-horizon LQR margin
    (enables short, well-conditioned horizons for regulation)."""
    x_ref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3)
    )
    sqp_iters: int = 6
    pgd_iters: int = 40
    g_shift: int = 12
    pad_to: int = 64

    @functools.cached_property
    def _Qf(self) -> np.ndarray:
        if self.Qf is not None:
            return np.asarray(self.Qf, float)
        return self.qf_scale * np.asarray(self.Q, float)

    def __post_init__(self):
        if self.pad_to % 4 or self.pad_to < 4:
            raise ValueError("pad_to must be a positive multiple of 4 lanes")

    # -- geometry -------------------------------------------------------------

    @functools.cached_property
    def _lane_scales(self) -> np.ndarray:
        return np.asarray(self.model.lane_scales, np.float64)

    @property
    def n_ctrl(self) -> int:
        return len(self._lane_scales)

    @property
    def n_dec(self) -> int:
        return self.n_ctrl * self.horizon

    @functools.cached_property
    def padded(self) -> int:
        return -(-self.n_dec // self.pad_to) * self.pad_to

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self.padded // 4), jnp.uint32)

    def _check_dims(self, n: int) -> None:
        """Validate Q/R/x_ref against the model's state dim ``n`` (known
        only after the first rollout) and the control channel count."""
        m, T = self.n_ctrl, self.horizon
        if np.asarray(self.Q).shape != (n, n):
            raise ValueError(
                f"Q has shape {np.asarray(self.Q).shape}; the model's "
                f"state dim is {n}"
            )
        if np.asarray(self.R).shape != (m, m):
            raise ValueError(
                f"R has shape {np.asarray(self.R).shape}; the model has "
                f"{m} control channel(s)"
            )
        xr = np.asarray(self.x_ref, float)
        if xr.shape not in ((n,), (T, n)):
            raise ValueError(
                f"x_ref has shape {xr.shape}; expected ({n},) or ({T}, {n})"
            )

    # -- public API -------------------------------------------------------------

    def solve(
        self,
        x0_f: np.ndarray,            # (B, n) float64 physical
        u_words: Optional[Array] = None,
        track_costs: bool = True,
    ) -> Tuple[Array, Optional[np.ndarray]]:
        """Run ``sqp_iters`` outer iterations.

        Returns (packed words (B, Tp/4), cost history (B, sqp_iters+1) of
        the true nonlinear objective, or None when ``track_costs=False`` --
        each cost sample is a full f64 reference rollout, which a closed
        loop discarding the history should not pay for).  Deterministic:
        same inputs, same words.
        """
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        if u_words is None:
            u_words = self.init_words(batch)
        elif u_words.shape != (batch, self.padded // 4):
            raise ValueError(
                f"u_words has shape {u_words.shape}; expected "
                f"({batch}, {self.padded // 4}) packed words for horizon "
                f"{self.horizon} x {self.n_ctrl} channel(s) padded to "
                f"{self.padded} lanes"
            )
        costs = (
            [self.true_cost(x0_f, self.lanes(u_words))] if track_costs else None
        )
        for _ in range(self.sqp_iters):
            lanes = self.lanes(u_words)  # (B, n_dec) host int32
            Hq, g_pre, hs_num, hs_den = self._condense_batch(x0_f, lanes)
            u_words = _pgd_batched_h(
                u_words,
                jnp.asarray(g_pre),
                jnp.asarray(Hq),
                jnp.asarray(hs_num),
                jnp.asarray(hs_den),
                iters=self.pgd_iters, g_shift=self.g_shift,
            )
            if track_costs:
                costs.append(self.true_cost(x0_f, self.lanes(u_words)))
        return u_words, (np.stack(costs, axis=-1) if track_costs else None)

    def _condense_batch(self, x0_f: np.ndarray, lanes: np.ndarray):
        """Vectorized linearize+condense+quantize for the whole batch.

        One batched pass replaces a ~4ms/problem Python loop.  The
        per-problem values match the scalar :func:`condense_ltv` +
        :func:`quantize` recipe up to float summation order (the batch
        path accumulates a shared Q plus a terminal Qf-Q correction), so
        an int8 Hessian entry can differ by one on a half-ulp rounding
        tie; both paths are equally valid quantizations of the same QP.
        Returns
        (Hq (B,Tp,Tp) int8, g_pre (B,Tp) int32, hs_num (B,) int32,
        hs_den (B,) int32)."""
        T, m = self.horizon, self.n_ctrl
        s = self._lane_scales
        batch = x0_f.shape[0]
        u_phys = lanes.reshape(batch, T, m) * s
        traj = self.model.reference_rollout(x0_f, u_phys)  # (B, T+1, n)
        self._check_dims(traj.shape[-1])
        A_seq, B_seq = self.model.linearize(traj[:, :-1], u_phys)
        c_seq = (
            traj[:, 1:]
            - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
            - np.einsum("bkij,bkj->bki", B_seq, u_phys)
        )
        Q = np.asarray(self.Q)
        R_lane = s[:, None] * np.asarray(self.R) * s[None, :]
        H, G, g_ref, lip = condense_ltv_batch(
            A_seq, B_seq * s, c_seq, Q, R_lane,
            self._Qf, np.asarray(self.x_ref, float),
        )
        return quantize_batch(
            H, G, g_ref, 1.0 / lip, x0_f, self.padded, self.g_shift
        )

    def lanes(self, u_words: Array) -> np.ndarray:
        """(B, 2T) int32 lane plan (drops the QP padding)."""
        return np.asarray(unpack_controls(u_words))[:, : self.n_dec]

    def plan_phys(self, u_words: Array) -> np.ndarray:
        """(B, T, m) physical control sequences."""
        lanes = self.lanes(u_words)
        return (
            lanes.reshape(lanes.shape[0], self.horizon, self.n_ctrl)
            * self._lane_scales
        )

    # -- diagnostics ---------------------------------------------------------

    def true_cost(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """The actual nonlinear objective of a lane plan (float64 rollout)."""
        T = self.horizon
        u_phys = lanes.reshape(-1, T, self.n_ctrl) * self._lane_scales
        traj = self.model.reference_rollout(np.atleast_2d(x0_f), u_phys)
        n = traj.shape[-1]
        self._check_dims(n)
        x_ref = np.broadcast_to(np.asarray(self.x_ref, float), (T, n))
        dx = traj[:, 1:] - x_ref
        Qs = np.stack([np.asarray(self.Q)] * (T - 1) + [self._Qf])
        state_cost = np.einsum("bki,kij,bkj->b", dx, Qs, dx)
        ctrl_cost = np.einsum("bki,ij,bkj->b", u_phys, np.asarray(self.R), u_phys)
        return state_cost + ctrl_cost

    # -- float64 reference (same algorithm, no quantization) -----------------

    def reference_solve(
        self, x0_f: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 SQP with the same linearize/condense/PGD structure.

        The oracle the quantized path is toleranced against: identical
        iteration counts and step rule, arithmetic in float64, box in lane
        units.  Returns (lane-valued plans (B, 2T) float64, cost history).
        """
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        T = self.horizon
        s = self._lane_scales
        U = np.zeros((batch, self.n_dec))
        costs = [self.true_cost(x0_f, U)]
        for _ in range(self.sqp_iters):
            for i in range(batch):
                u_phys = U[i].reshape(T, self.n_ctrl) * s
                traj = self.model.reference_rollout(x0_f[i], u_phys)
                A_seq, B_seq = self.model.linearize(traj[:-1], u_phys)
                c_seq = (
                    traj[1:]
                    - np.einsum("kij,kj->ki", A_seq, traj[:-1])
                    - np.einsum("kij,kj->ki", B_seq, u_phys)
                )
                qp = condense_ltv(
                    A_seq, B_seq * s, c_seq, np.asarray(self.Q),
                    s[:, None] * np.asarray(self.R) * s[None, :],
                    self._Qf, self.x_ref, u_max=127.0,
                )
                g = qp.G @ x0_f[i] + qp.g_ref
                alpha = 1.0 / qp.lipschitz
                u = U[i].copy()
                for _ in range(self.pgd_iters):
                    u = np.clip(u - alpha * (qp.H @ u + g), -127.0, 127.0)
                U[i] = u
            costs.append(self.true_cost(x0_f, U))
        return U, np.stack(costs, axis=-1)


@dataclasses.dataclass(frozen=True)
class SQPController:
    """Real-time-iteration closed loop: receding-horizon SQP MPC.

    Per tick: run ``iters_per_tick`` SQP iterations warm-started from the
    shifted previous plan (classic RTI -- one linearize/condense/solve pass
    per control period tracks the optimum as the state evolves), apply the
    first control on the **quantized plant** (the model's fixed-point
    ``step``), shift the packed plan by one step.

    The device program is the same batched fixed-point PGD for every tick
    (zero recompiles after the first); host work per tick is one
    linearization + condensation per problem.  Fully deterministic.
    """

    sqp: QuantizedSQP
    iters_per_tick: int = 1

    def run(
        self,
        x0_f: np.ndarray,
        ticks: int,
        u_words: Optional[Array] = None,
        x_ref_traj: Optional[np.ndarray] = None,
    ):
        """Returns (states (B, ticks+1, n) int32 fixed-point, applied
        controls (B, ticks, m) int32 lanes).

        ``u_words`` warm-starts the first tick -- the plan-then-track
        pattern: compute a full-depth SQP plan offline (e.g. a pendulum
        swing-up), then let the per-tick real-time iterations track it
        through the quantized plant.  RTI is a tracking scheme; from a cold
        plan it converges to the nearest local solution, which for strongly
        underactuated tasks may be an equilibrium short of the goal.

        ``x_ref_traj`` (>= ticks + horizon, n) turns the loop into a
        **trajectory tracker**: each tick's QP uses the sliding window
        ``x_ref_traj[t+1 : t+1+horizon]`` as its per-step reference.  For
        unstable plants this is the right decomposition: long-horizon
        planning offline, short-horizon (well-conditioned) tracking online
        -- condensation of an unstable plant conditions like e^(2*lambda*T),
        so the tracking horizon should be short.
        """
        tick_sqp = dataclasses.replace(self.sqp, sqp_iters=self.iters_per_tick)
        model = self.sqp.model
        m, n_dec = self.sqp.n_ctrl, self.sqp.n_dec
        T = self.sqp.horizon
        if x_ref_traj is not None:
            x_ref_traj = np.asarray(x_ref_traj, np.float64)
            if x_ref_traj.shape[0] < ticks + T:
                raise ValueError(
                    f"x_ref_traj has {x_ref_traj.shape[0]} steps; tracking "
                    f"{ticks} ticks at horizon {T} needs >= {ticks + T}"
                )
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        state_fp = jnp.asarray(model.to_fixed(x0_f))
        words = self.sqp.init_words(batch) if u_words is None else u_words
        states = [np.asarray(state_fp)]
        applied = []
        for t in range(ticks):
            x_f = model.to_float(np.asarray(state_fp))
            if x_ref_traj is not None:
                tick_sqp = dataclasses.replace(
                    tick_sqp, x_ref=x_ref_traj[t + 1 : t + 1 + T]
                )
            words, _ = tick_sqp.solve(x_f, u_words=words, track_costs=False)
            lanes = np.asarray(unpack_controls(words))  # (B, Tp)
            u0 = lanes[:, :m]
            state_fp = model.step(
                state_fp, *(jnp.asarray(u0[:, c]) for c in range(m))
            )
            # warm shift: drop the applied step, zero the tail
            shifted = np.zeros_like(lanes)
            shifted[:, : n_dec - m] = lanes[:, m:n_dec]
            words = pack_controls(jnp.asarray(shifted))
            states.append(np.asarray(state_fp))
            applied.append(u0)
        return np.stack(states, axis=1), np.stack(applied, axis=1)
