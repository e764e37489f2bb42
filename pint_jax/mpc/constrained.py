"""Hard linear state constraints: augmented-Lagrangian fixed-point MPC.

The condensed solvers in this package enforce only the control box (the
int8 lane saturation boundary).  This module adds **hard polytopic state
constraints** ``lo <= F x_k <= hi`` for every step of the horizon -- the
missing half of real MPC problems (corridor bounds, velocity limits,
actuator-rate limits expressed on states).

No counterpart exists in the reference library (SURVEY.md section 2.4): this
extends the BASELINE.json MPC capability layer.  The method is the standard
two-sided augmented Lagrangian in its projection form (the same shape OSQP
uses for its dual updates):

    c(U, x0) = S U + P x0 + r          (stacked F x_k rows, k = 1..T)
    L(U, lam) = f(U) + rho/2 * dist^2(c + lam/rho, [lo, hi]) - |lam|^2/(2 rho)

    inner:  minimize_U L over the control box   (projected gradient)
    outer:  lam <- rho * (t - Pi(t)),  t = c(U*) + lam/rho

which decomposes into exactly the primitives the fixed-point PGD
solver already uses, plus two extra int8 matmuls per inner iteration
(``lanes @ Sq^T`` for the constraint evaluation and ``y8 @ Sq`` for the
penalty gradient).  The quantized device solver lives in this module too
(:class:`ConstrainedPGD`); this file's host tier provides the float64
reference (same iteration, same projection form) that the quantized solver
is tolerance-checked against, mirroring ``CondensedQP.solve_pgd``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.mpc.condensed import CondensedQP, QuantizedQP, quantize

__all__ = [
    "StateConstrainedQP",
    "QuantizedConstrainedQP",
    "ConstrainedPGD",
    "ConstrainedController",
    "constrain_states",
    "quantize_constrained",
]

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class StateConstrainedQP:
    """A condensed QP plus stacked linear state constraints.

    minimize 1/2 U^T H U + g(x0)^T U
    s.t.     |U| <= u_max                      (control box)
             lo <= S U + P x0 + r <= hi        (state rows, C of them)
    """

    qp: CondensedQP
    S: np.ndarray        # (C, Tm)
    P: np.ndarray        # (C, n)
    r: np.ndarray        # (C,)
    lo: np.ndarray       # (C,)
    hi: np.ndarray       # (C,)
    penalty_lipschitz: float   # lambda_max(S^T S)

    def constraint(self, U: np.ndarray, x0: np.ndarray) -> np.ndarray:
        """c(U, x0), batched over leading dims."""
        return U @ self.S.T + np.atleast_2d(x0) @ self.P.T + self.r

    def solve_alm(
        self,
        x0: np.ndarray,
        rho: float = 10.0,
        outer: int = 12,
        inners: int = 60,
        step: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Float64 augmented-Lagrangian reference solver (CPU oracle).

        Batched over leading dims of x0.  Returns ``(U, lam)``.  The
        quantized device solver runs this exact iteration in fixed point;
        tests check both against scipy and KKT residuals.

        Structurally infeasible starts (no control keeps the state inside
        the bounds) degrade gracefully: the penalty form converges to a
        bounded least-violation compromise instead of diverging, the MPC
        equivalent of a soft-constraint fallback.
        """
        qp = self.qp
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        B = x0.shape[0]
        Tm = qp.H.shape[0]
        C = self.S.shape[0]
        L = qp.lipschitz + rho * self.penalty_lipschitz
        alpha = step if step is not None else 1.0 / L
        U = np.zeros((B, Tm))
        lam = np.zeros((B, C))
        cx0 = x0 @ self.P.T + self.r          # (B, C)
        g0 = x0 @ qp.G.T + qp.g_ref           # (B, Tm)
        for _ in range(outer):
            for _ in range(inners):
                t = U @ self.S.T + cx0 + lam / rho
                y = t - np.clip(t, self.lo, self.hi)
                grad = U @ qp.H.T + g0 + rho * (y @ self.S)
                U = np.clip(U - alpha * grad, -qp.u_max, qp.u_max)
            t = U @ self.S.T + cx0 + lam / rho
            lam = rho * (t - np.clip(t, self.lo, self.hi))
        return np.squeeze(U) if x0.ndim == 1 else U, lam

    def kkt_residual(
        self, U: np.ndarray, lam: np.ndarray, x0: np.ndarray
    ) -> np.ndarray:
        """Natural-map KKT residual ||U - Pi_box(U - grad L)||_inf per
        problem: zero exactly at a constrained optimum."""
        qp = self.qp
        U = np.atleast_2d(np.asarray(U, np.float64))
        x0 = np.atleast_2d(np.asarray(x0, np.float64))
        g0 = x0 @ qp.G.T + qp.g_ref
        grad = U @ qp.H.T + g0 + np.atleast_2d(lam) @ self.S
        proj = np.clip(U - grad, -qp.u_max, qp.u_max)
        return np.abs(U - proj).max(axis=-1)


def constrain_states(
    qp: CondensedQP,
    A_seq: np.ndarray,
    B_seq: np.ndarray,
    c_seq: Optional[np.ndarray],
    F: np.ndarray,
    lo,
    hi,
) -> StateConstrainedQP:
    """Stack per-step state constraints ``lo <= F x_k <= hi`` (k = 1..T)
    into condensed rows over the decision vector U.

    ``A_seq``/``B_seq`` are (T, n, n)/(T, n, m) -- pass ``np.broadcast_to``
    of the LTI pair for time-invariant plants; ``c_seq`` (T, n) or None are
    the affine offsets (LTV/SQP linearizations).  ``F`` is (Cs, n); ``lo``,
    ``hi`` are scalars or (Cs,) and apply at every step.

    The propagators are the same forward recursion as
    :func:`pint_jax.mpc.condensed.condense_ltv` (Abar_k = A_k Abar_{k-1},
    ...); rows for step k read  F Bbar_k U + F Abar_k x0 + F Cbar_k.
    """
    A_seq = np.asarray(A_seq, float)
    B_seq = np.asarray(B_seq, float)
    T, n, m = B_seq.shape
    if A_seq.shape != (T, n, n):
        raise ValueError(f"A_seq {A_seq.shape} vs B_seq {B_seq.shape}")
    c_seq = np.zeros((T, n)) if c_seq is None else np.asarray(c_seq, float)
    F = np.atleast_2d(np.asarray(F, float))
    Cs = F.shape[0]
    if F.shape[1] != n:
        raise ValueError(f"F has {F.shape[1]} columns, state dim is {n}")
    lo = np.broadcast_to(np.asarray(lo, float), (Cs,))
    hi = np.broadcast_to(np.asarray(hi, float), (Cs,))
    if np.any(lo >= hi):
        raise ValueError("state constraint lo must be < hi per row")

    S = np.zeros((T * Cs, T * m))
    P = np.zeros((T * Cs, n))
    r = np.zeros(T * Cs)
    Bbar = np.zeros((n, T * m))
    Ak_prod = np.eye(n)
    c_acc = np.zeros(n)
    for k in range(T):
        Ak_prod = A_seq[k] @ Ak_prod
        if k:
            Bbar = A_seq[k] @ Bbar
        Bbar[:, k * m : (k + 1) * m] = B_seq[k]
        c_acc = A_seq[k] @ c_acc + c_seq[k]
        S[k * Cs : (k + 1) * Cs] = F @ Bbar
        P[k * Cs : (k + 1) * Cs] = F @ Ak_prod
        r[k * Cs : (k + 1) * Cs] = F @ c_acc

    pen_lip = float(np.linalg.eigvalsh(S.T @ S).max())
    return StateConstrainedQP(
        qp=qp,
        S=S,
        P=P,
        r=r,
        lo=np.tile(lo, T),
        hi=np.tile(hi, T),
        penalty_lipschitz=pen_lip,
    )


# ---------------------------------------------------------------------------
# Quantized device tier
# ---------------------------------------------------------------------------

# fixed-point geometry of the constraint plane ("c-pre" units):
#   c_phys = c_pre * c_unit, with c_unit = c_ref / 2**C_BITS so that the
#   reachable |S U| range spans ~2**(C_BITS-1).  All constraint-side state
#   (bounds, offsets, multipliers, violations) is int32 in these units.
_C_BITS = 20
_LAM_CAP = np.int32(1 << 22)      # |lam/rho| cap in c-pre units (safeguarded ALM)
_CX0_CAP = 1 << 22                # host-side clip of the x0-dependent offset
_Y_BITS = 13                      # y is split into two int8 planes (14-bit total)


@dataclasses.dataclass(frozen=True)
class QuantizedConstrainedQP:
    """Fixed-point operands for the device ALM solver.

    The objective side reuses :class:`QuantizedQP` quantized at the
    penalty-augmented step 1/(L_H + rho * L_S); the constraint side adds an
    int8 row matrix ``Sq`` and the int32 rational ladders that move values
    between the matmul-accumulator, c-pre and pre-shift-lane-unit scales:

      c_pre     = (lanes @ Sq^T) * cs_num >> cs_den        (+ cx0_pre)
      y14       = (t - clip(t, lo, hi) + ef) >> y_shift    (14-bit, EF carried)
      extra_pre = (y_hi @ Sq) * eh_num >> eh_den
                + (y_lo @ Sq) * el_num >> el_den           (penalty gradient)

    Every rational numerator is budgeted so the int32 product of the worst-
    case accumulator magnitude cannot overflow (same discipline as
    ``QuantizedQP.hs_num``, condensed.py).
    """

    scqp: StateConstrainedQP
    qqp: QuantizedQP
    rho: float
    Sq: np.ndarray          # (Cp, Tp) int8
    s_scale: float
    c_unit: float
    cs_num: int
    cs_den: int
    eh_num: int
    eh_den: int
    el_num: int
    el_den: int
    y_shift: int
    lo_pre: np.ndarray      # (Cp,) int32 (padded rows get wide sentinels)
    hi_pre: np.ndarray
    n_rows: int             # C (unpadded)
    padded_rows: int        # Cp

    def c_off_pre(self, x0_phys: np.ndarray) -> np.ndarray:
        """int32 x0-dependent constraint offset (P x0 + r) in c-pre units,
        padded; the per-solve host prep mirroring QuantizedQP.g_lane_fixed."""
        sc = self.scqp
        x0 = np.atleast_2d(np.asarray(x0_phys, np.float64))
        off = x0 @ sc.P.T + sc.r
        off = np.nan_to_num(off / self.c_unit, posinf=_CX0_CAP, neginf=-_CX0_CAP)
        off = np.clip(np.round(off), -_CX0_CAP, _CX0_CAP).astype(np.int32)
        pad = self.padded_rows - self.n_rows
        if pad:
            off = np.concatenate(
                [off, np.zeros(off.shape[:-1] + (pad,), np.int32)], axis=-1
            )
        return off


def _rational(value: float, acc_max: int, budget: int, what: str):
    """Largest-denominator int32 rational num/2**den ~ value such that
    |acc| <= acc_max keeps acc*num within ``budget`` (condensed.py:404-419
    discipline, with a configurable budget for multi-term sums)."""
    num_max = budget // acc_max
    if num_max < 1 or value <= 0:
        raise ValueError(f"{what}: scale {value!r} unrepresentable")
    den = max(0, min(31, int(np.floor(np.log2(num_max / value)))))
    num = int(round(value * 2**den))
    if num < 1 or num > num_max:
        raise ValueError(
            f"{what}: scale {value!r} out of the int32 rational budget "
            f"(num={num}, max={num_max}); rescale the problem or rho"
        )
    return num, den


def quantize_constrained(
    scqp: StateConstrainedQP,
    rho: float = 50.0,
    g_shift: int = 12,
    pad_to: int = 64,
) -> QuantizedConstrainedQP:
    """Quantize a state-constrained QP for the int8 ALM solver."""
    qp = scqp.qp
    # the inner problem's curvature includes the penalty Hessian rho S^T S;
    # folding the augmented Lipschitz into a derived CondensedQP reuses the
    # whole objective-side quantization path unchanged
    lip = qp.lipschitz + rho * scqp.penalty_lipschitz
    qp_aug = CondensedQP(
        H=qp.H, G=qp.G, g_ref=qp.g_ref, u_max=qp.u_max, lipschitz=lip
    )
    qqp = quantize(qp_aug, g_shift=g_shift, pad_to=pad_to)
    alpha = 1.0 / lip

    C, Tm = scqp.S.shape
    Tp = qqp.padded
    Cp = -(-C // pad_to) * pad_to
    s_scale = float(np.abs(scqp.S).max()) / 127.0
    if s_scale == 0.0:
        raise ValueError("constraint matrix S is identically zero")
    Sq = np.zeros((Cp, Tp), np.int8)
    Sq[:C, :Tm] = np.round(scqp.S / s_scale).astype(np.int8)

    # c-pre geometry: c_ref spans the reachable |S U| plus the bound range
    row_amp = float(np.abs(scqp.S).sum(axis=1).max()) * qp.u_max
    b_amp = float(max(np.abs(scqp.lo).max(), np.abs(scqp.hi).max()))
    c_ref = 2.0 * (row_amp + b_amp)
    c_unit = c_ref / float(1 << _C_BITS)

    # lanes @ Sq^T accumulator -> c-pre
    cs_f = qqp.u_scale * s_scale / c_unit
    cs_num, cs_den = _rational(cs_f, 127 * 127 * Tp, 2**31 - 1, "cs")

    # y-split matmul accumulators -> pre-shift lane units.  y14 is exact
    # (y_hi*128 + y_lo); worst-case |t| sets the shift so y14 fits 14 bits.
    t_amp = float(1 << (_C_BITS - 1)) + float(_CX0_CAP) + float(_LAM_CAP)
    y_shift = max(0, int(np.ceil(np.log2(t_amp * 2.0))) - _Y_BITS)
    base = rho * s_scale * float(1 << y_shift) * c_unit * alpha / qqp.u_scale
    base *= float(1 << g_shift)
    # each term gets half the int32 budget so their sum cannot overflow
    eh_num, eh_den = _rational(base * 128.0, 64 * 127 * Cp, 2**30 - 1, "eh")
    el_num, el_den = _rational(base, 127 * 127 * Cp, 2**30 - 1, "el")

    sent = np.int32(1 << 30)
    lo_pre = np.full(Cp, -sent, np.int32)
    hi_pre = np.full(Cp, sent, np.int32)
    lo_pre[:C] = np.clip(np.round(scqp.lo / c_unit), -sent, sent)
    hi_pre[:C] = np.clip(np.round(scqp.hi / c_unit), -sent, sent)

    return QuantizedConstrainedQP(
        scqp=scqp,
        qqp=qqp,
        rho=rho,
        Sq=Sq,
        s_scale=s_scale,
        c_unit=c_unit,
        cs_num=cs_num,
        cs_den=cs_den,
        eh_num=eh_num,
        eh_den=eh_den,
        el_num=el_num,
        el_den=el_den,
        y_shift=y_shift,
        lo_pre=lo_pre,
        hi_pre=hi_pre,
        n_rows=C,
        padded_rows=Cp,
    )


@dataclasses.dataclass(frozen=True)
class ConstrainedPGD:
    """Device ALM solver: outer multiplier updates around an error-feedback
    fixed-point PGD inner loop, one XLA program, integer end to end.

    Per inner iteration: two int8 matmuls on the objective side
    (``lanes @ Hq^T``) and constraint side (``lanes @ Sq^T``), the split
    penalty-gradient matmuls (``y_hi/y_lo @ Sq``), int32 rescales, and
    the saturating packed-word update (add_signed_saturate + max_signed) --
    the same substrate as :class:`pint_jax.mpc.solver.FixedPointPGD` with
    the constraint plane alongside.  Bit-deterministic: pure integer ops,
    so dp-sharding over a mesh reproduces the single-device words exactly.
    """

    qcqp: QuantizedConstrainedQP
    outer: int = 10
    inners: int = 40

    @property
    def _q(self) -> QuantizedQP:
        return self.qcqp.qqp

    @functools.cached_property
    def _lower_word(self) -> np.ndarray:
        from pint_jax.models.dynamics import CONTROL_LAYOUT

        w = 0
        for off in CONTROL_LAYOUT.offsets:
            w |= (-127 & 0xFF) << off
        return np.uint32(w)

    def init_words(self, batch: int) -> Array:
        return jnp.zeros((batch, self._q.padded // 4), jnp.uint32)

    # -- device program ------------------------------------------------------

    def _c_pre(self, lanes: Array) -> Array:
        q = self.qcqp
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            jnp.asarray(q.Sq),
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (B, Cp)
        return (acc * np.int32(q.cs_num)) >> np.int32(q.cs_den)

    def solve_words(
        self,
        u_words: Array,
        g_pre: Array,
        c_off: Array,
        lam0: Optional[Array] = None,
    ) -> Tuple[Array, Array]:
        """Run ``outer`` multiplier updates x ``inners`` PGD steps.

        u_words (B, Tp/4) uint32; g_pre (B, Tp) int32 (QuantizedQP.
        g_lane_fixed); c_off (B, Cp) int32 (QuantizedConstrainedQP.
        c_off_pre); lam0 (B, Cp) int32 optional multiplier warm start
        (lam/rho in c-pre units -- receding-horizon ticks shift and reuse
        the previous tick's multipliers).  Returns (words, lam_pre).
        Pure: jit/vmap/shard_map safe.
        """
        from pint_jax.models.dynamics import pack_controls, unpack_controls
        from pint_jax.models.dynamics import CONTROL_LAYOUT
        from pint_jax.ops import word as W

        q = self.qcqp
        qq = self._q
        Hq = jnp.asarray(qq.Hq)
        Sq = jnp.asarray(q.Sq)
        lo = jnp.asarray(q.lo_pre)
        hi = jnp.asarray(q.hi_pre)
        half = np.int32(1 << (qq.g_shift - 1))
        y_half = np.int32(1 << q.y_shift >> 1) if q.y_shift else np.int32(0)
        y_cap = np.int32((1 << _Y_BITS) - 1)
        lower = jnp.broadcast_to(
            jnp.full((1,), self._lower_word, jnp.uint32), u_words.shape
        )

        def inner(_, st):
            words, carry, ey, lam = st
            lanes = unpack_controls(words)
            acc = jax.lax.dot_general(
                lanes.astype(jnp.int8), Hq,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            pre = (acc * np.int32(qq.hs_num)) >> np.int32(qq.hs_den)
            t = self._c_pre(lanes) + c_off + lam
            y = t - jnp.clip(t, lo, hi) + ey
            y14 = jnp.clip(
                (y + y_half) >> np.int32(q.y_shift), -y_cap, y_cap
            )
            ey = y - (y14 << np.int32(q.y_shift))
            y_hi = y14 >> np.int32(7)
            y_lo = y14 - (y_hi << np.int32(7))
            acc_h = jax.lax.dot_general(
                y_hi.astype(jnp.int8), Sq,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            acc_l = jax.lax.dot_general(
                y_lo.astype(jnp.int8), Sq,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )
            extra = ((acc_h * np.int32(q.eh_num)) >> np.int32(q.eh_den)) + (
                (acc_l * np.int32(q.el_num)) >> np.int32(q.el_den)
            )
            step = -(pre + g_pre + extra) + carry
            delta = jnp.clip((step + half) >> np.int32(qq.g_shift), -128, 127)
            carry = step - (delta << np.int32(qq.g_shift))
            words = W.add_signed_saturate(
                CONTROL_LAYOUT, words, pack_controls(delta)
            )
            words = W.max_signed(CONTROL_LAYOUT, words, lower)
            return words, carry, ey, lam

        def outer(_, st):
            words, carry, ey, lam = st
            words, carry, ey, lam = jax.lax.fori_loop(
                0, self.inners, inner, (words, carry, ey, lam)
            )
            # multiplier update at the inner solution: lam/rho <- t - Pi(t),
            # computed from the EXACT int32 violation (no y-quantization)
            t = self._c_pre(unpack_controls(words)) + c_off + lam
            lam = jnp.clip(t - jnp.clip(t, lo, hi), -_LAM_CAP, _LAM_CAP)
            return words, carry, ey, lam

        # device-varying zero inits (shard_map's varying-manual-axes check
        # rejects literal-zero carries; derive them from the inputs)
        carry0 = g_pre ^ g_pre
        ey0 = c_off ^ c_off
        if lam0 is None:
            lam0 = ey0
        words, _, _, lam = jax.lax.fori_loop(
            0, self.outer, outer, (u_words, carry0, ey0, lam0)
        )
        return words, lam

    # -- host conveniences ----------------------------------------------------

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array, Array]:
        """End-to-end batched solve: (words, U_phys (B, T) f32, lam_pre)."""
        from pint_jax.models.dynamics import unpack_controls

        x0 = np.atleast_2d(x0_phys)
        g_pre = jnp.asarray(self._q.g_lane_fixed(x0))
        c_off = jnp.asarray(self.qcqp.c_off_pre(x0))
        words, lam = jax.jit(self.solve_words)(
            self.init_words(x0.shape[0]), g_pre, c_off
        )
        lanes = unpack_controls(words)[:, : self._q.horizon]
        return words, lanes.astype(jnp.float32) * np.float32(
            self._q.u_scale
        ), lam


@dataclasses.dataclass(frozen=True)
class ConstrainedController:
    """Receding-horizon closed loop with hard state constraints.

    The constrained counterpart of :class:`pint_jax.mpc.controller.
    LTIController`: each tick re-solves the ALM problem from the current
    fixed-point state, applies the first control, steps the plant, and warm
    starts the next tick by shifting BOTH the packed plan (m lanes) and the
    multiplier plane (one constraint-row block -- rows are time-major, so
    the shift re-aligns each step's duals with the receding horizon).  Warm
    multipliers are what make small per-tick budgets (a few outer updates)
    track the constraint boundary: the active set barely changes between
    ticks, so lam is already near its fixed point.

    The whole loop is one jitted ``lax.scan``: no host round-trips.
    """

    qcqp: QuantizedConstrainedQP
    plant_step: callable = dataclasses.field(repr=False)
    inputs_per_step: int = 1
    frac_bits: int = 16
    outer_per_tick: int = 3
    inners_per_outer: int = 15

    @functools.cached_property
    def _solver(self) -> ConstrainedPGD:
        return ConstrainedPGD(
            self.qcqp, outer=self.outer_per_tick, inners=self.inners_per_outer
        )

    @functools.cached_property
    def _g_mat(self) -> np.ndarray:
        q = self.qcqp.qqp
        scale = q.Gq_scale * 2.0**-self.frac_bits
        n = q.qp.G.shape[1]
        G = np.zeros((n, q.padded), np.float32)
        G[:, : q.horizon] = (q.qp.G * scale).T.astype(np.float32)
        return G

    @functools.cached_property
    def _g_ref(self) -> np.ndarray:
        q = self.qcqp.qqp
        gr = np.zeros((q.padded,), np.float32)
        gr[: q.horizon] = (q.qp.g_ref * q.Gq_scale).astype(np.float32)
        return gr

    @functools.cached_property
    def _c_mat(self) -> np.ndarray:
        """Folded f32 map state_fp -> c_off_pre (like _g_mat for g_pre)."""
        q = self.qcqp
        scale = 2.0**-self.frac_bits / q.c_unit
        n = q.scqp.P.shape[1]
        Pm = np.zeros((n, q.padded_rows), np.float32)
        Pm[:, : q.n_rows] = (q.scqp.P * scale).T.astype(np.float32)
        return Pm

    @functools.cached_property
    def _c_ref(self) -> np.ndarray:
        q = self.qcqp
        cr = np.zeros((q.padded_rows,), np.float32)
        cr[: q.n_rows] = (q.scqp.r / q.c_unit).astype(np.float32)
        return cr

    def tick(self, state_fp: Array, u_words: Array, lam: Array):
        q = self.qcqp.qqp
        s_f = state_fp.astype(jnp.float32)
        g = jnp.round(
            s_f @ jnp.asarray(self._g_mat) + jnp.asarray(self._g_ref)
        ).astype(jnp.int32)
        c_off = jnp.round(
            s_f @ jnp.asarray(self._c_mat) + jnp.asarray(self._c_ref)
        ).astype(jnp.int32)
        u_words, lam = self._solver.solve_words(u_words, g, c_off, lam)
        from pint_jax.models.dynamics import pack_controls, unpack_controls

        lanes = unpack_controls(u_words)
        m = self.inputs_per_step
        u0 = lanes[..., :m]
        state2 = self.plant_step(state_fp, u0)
        shifted = jnp.concatenate(
            [lanes[..., m:], jnp.zeros_like(lanes[..., :m])], axis=-1
        )
        # shift multipliers one time block (rows are time-major; padded
        # tail rows carry lam = 0 already, so the zero-fill is consistent).
        # qqp.horizon is the decision length T*m, so rows-per-step is
        # n_rows / T = n_rows * m / horizon
        rb = self.qcqp.n_rows * m // q.horizon
        lam2 = jnp.concatenate(
            [lam[..., rb:], jnp.zeros_like(lam[..., :rb])], axis=-1
        )
        return state2, pack_controls(shifted), lam2, u0

    def run(self, state0_fp: Array, ticks: int):
        """Closed loop; returns (states (B, ticks+1, n), applied control
        lanes (B, ticks, m))."""
        q = self.qcqp
        u0_words = jnp.zeros(
            state0_fp.shape[:-1] + (q.qqp.padded // 4,), jnp.uint32
        )
        lam0 = jnp.zeros(state0_fp.shape[:-1] + (q.padded_rows,), jnp.int32)

        def body(carry, _):
            state, words, lam = carry
            state2, words2, lam2, u0 = self.tick(state, words, lam)
            return (state2, words2, lam2), (state2, u0)

        (_, _, _), (states, lanes) = jax.lax.scan(
            body, (state0_fp, u0_words, lam0), None, length=ticks
        )
        states = jnp.moveaxis(states, 0, -2)
        lanes = jnp.moveaxis(lanes, 0, -2)
        states = jnp.concatenate([state0_fp[..., None, :], states], axis=-2)
        return states, lanes
