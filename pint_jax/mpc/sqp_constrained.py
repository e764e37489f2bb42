"""State-constrained nonlinear SQP: hard ``lo <= F x <= hi`` on packed plans.

Combines the two second-order tiers of this package: the SQP outer loop of
:class:`pint_jax.mpc.ltv.QuantizedSQP` (linearize the exact nonlinear map
along the nominal, condense time-varying affine dynamics in lane units) and
the augmented-Lagrangian constraint machinery of
:mod:`pint_jax.mpc.constrained` (stacked state-constraint rows, int8
penalty gradients, exact int32 multiplier updates).  Per SQP iteration the
constraint rows are re-stacked from the fresh linearization's propagators
(x_{k+1} = Abar_k x0 + Bbar_k U + Cbar_k), and the multipliers carry over
-- rows keep their meaning (step k's constraint) across relinearization, so
the active set converges with the trajectory.

Because every problem linearizes around its own trajectory, *all* constraint
operands are per-problem runtime tensors: Sq (B, Cp, Tp) int8 rows, c-unit
rationals, bounds -- mirroring how the inner Hessian is batched in
``_pgd_batched_h`` (ltv.py).  One XLA program serves every SQP iteration.

No counterpart in the reference library (SURVEY.md section 2.4): this is
BASELINE.json capability layer.  Packed-word machinery exercised per inner
iteration: add_signed_saturate (pint.hpp:857-866), max_signed
(pint.hpp:987-1004), pack/unpack (pint.hpp:390-407, 799-822).
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
from pint_jax.mpc.condensed import condense_ltv_batch
from pint_jax.mpc.constrained import _C_BITS, _CX0_CAP, _LAM_CAP, _Y_BITS
from pint_jax.mpc.ltv import QuantizedSQP, _lower_words, quantize_batch
from pint_jax.ops import word as W

Array = jax.Array

__all__ = ["ConstrainedSQP"]

# static y-split shift: the worst-case |t| bound is layout-independent
# (2**(_C_BITS-1) reachable c-pre + offset cap + multiplier cap), so the
# 14-bit split point is one compile-time constant for every problem
_T_AMP = float(1 << (_C_BITS - 1)) + float(_CX0_CAP) + float(_LAM_CAP)
_Y_SHIFT = max(0, int(np.ceil(np.log2(_T_AMP * 2.0))) - _Y_BITS)


def _rational_vec(
    val: np.ndarray, acc_max: int, budget: int, what: str
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized int32 rational num/2**den ~ val with overflow budget
    (the batched form of mpc.constrained._rational)."""
    num_max = budget // acc_max
    if num_max < 1 or (val <= 0).any():
        raise ValueError(f"{what}: unrepresentable scale in batch")
    den = np.clip(np.floor(np.log2(num_max / val)), 0, 31).astype(np.int32)
    num = np.round(val * 2.0**den).astype(np.int64)
    if (num < 1).any() or (num > num_max).any():
        raise ValueError(
            f"{what}: scale out of the int32 rational budget; rescale the "
            "problem or rho"
        )
    return num.astype(np.int32), den


@functools.partial(
    jax.jit, static_argnames=("outer", "inners", "g_shift", "y_shift")
)
def _alm_batched(
    u_words: Array,   # (B, Tp/4) uint32
    g_pre: Array,     # (B, Tp) int32
    Hq: Array,        # (B, Tp, Tp) int8
    hs_num: Array,    # (B,) int32
    hs_den: Array,    # (B,) int32
    Sq: Array,        # (B, Cp, Tp) int8
    cs_num: Array,    # (B,) int32
    cs_den: Array,    # (B,) int32
    c_off: Array,     # (B, Cp) int32
    lo_pre: Array,    # (B, Cp) int32
    hi_pre: Array,    # (B, Cp) int32
    eh_num: Array,    # (B,) int32
    eh_den: Array,
    el_num: Array,
    el_den: Array,
    lam0: Array,      # (B, Cp) int32
    *,
    outer: int,
    inners: int,
    g_shift: int,
    y_shift: int,
) -> Tuple[Array, Array]:
    """Batched device ALM with per-problem Hessians AND constraint rows:
    the state-constrained SQP inner solve.  Same iteration as
    ``ConstrainedPGD.solve_words`` (mpc/constrained.py) with every operand
    batched, same error-feedback discipline as ``_pgd_batched_h``."""
    lower = jnp.full((1,), _lower_words(), jnp.uint32)
    half = np.int32(1 << (g_shift - 1))
    y_half = np.int32((1 << y_shift) >> 1) if y_shift else np.int32(0)
    y_cap = np.int32((1 << _Y_BITS) - 1)

    def c_pre_of(lanes):
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8), Sq,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, Cp)
        return (acc * cs_num[:, None]) >> cs_den[:, None]

    def inner(_, st):
        words, carry, ey, lam = st
        lanes = unpack_controls(words)
        acc = jax.lax.dot_general(
            lanes.astype(jnp.int8), Hq,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )
        pre = (acc * hs_num[:, None]) >> hs_den[:, None]
        t = c_pre_of(lanes) + c_off + lam
        y = t - jnp.clip(t, lo_pre, hi_pre) + ey
        y14 = jnp.clip((y + y_half) >> np.int32(y_shift), -y_cap, y_cap)
        ey = y - (y14 << np.int32(y_shift))
        y_hi = y14 >> np.int32(7)
        y_lo = y14 - (y_hi << np.int32(7))
        # one stacked matmul for both split halves: they contract over the
        # same Cp axis of the same Sq, so stacking halves the number of
        # passes over the (B, Cp, Tp) int8 rows (the inner loop's
        # dominant traffic); integer dot is exact, so results are
        # bit-identical to two separate matmuls
        y_stack = jnp.stack(
            [y_hi.astype(jnp.int8), y_lo.astype(jnp.int8)], axis=1
        )  # (B, 2, Cp)
        acc_hl = jax.lax.dot_general(
            y_stack, Sq,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, 2, Tp)
        extra = (
            (acc_hl[:, 0] * eh_num[:, None]) >> eh_den[:, None]
        ) + ((acc_hl[:, 1] * el_num[:, None]) >> el_den[:, None])
        step = -(pre + g_pre + extra) + carry
        delta = jnp.clip((step + half) >> np.int32(g_shift), -128, 127)
        carry = step - (delta << np.int32(g_shift))
        words = W.add_signed_saturate(
            CONTROL_LAYOUT, words, pack_controls(delta)
        )
        words = W.max_signed(
            CONTROL_LAYOUT, words, jnp.broadcast_to(lower, words.shape)
        )
        return words, carry, ey, lam

    def outer_body(_, st):
        words, carry, ey, lam = st
        words, carry, ey, lam = jax.lax.fori_loop(
            0, inners, inner, (words, carry, ey, lam)
        )
        t = c_pre_of(unpack_controls(words)) + c_off + lam
        lam = jnp.clip(t - jnp.clip(t, lo_pre, hi_pre), -_LAM_CAP, _LAM_CAP)
        return words, carry, ey, lam

    carry0 = g_pre ^ g_pre
    ey0 = c_off ^ c_off
    words, _, _, lam = jax.lax.fori_loop(
        0, outer, outer_body, (u_words, carry0, ey0, lam0)
    )
    return words, lam


def _alm_cols_loop(
    u_words: Array,   # (B, block/4) uint32: this rank's iterate columns
    g_r: Array,       # (B, block) int32
    hs_num: Array,
    hs_den: Array,
    cs_num: Array,
    cs_den: Array,
    c_off: Array,     # (B, Cp) int32 (tp-replicated)
    lo_pre: Array,
    hi_pre: Array,
    eh_num: Array,
    eh_den: Array,
    el_num: Array,
    el_den: Array,
    lam0: Array,      # (B, Cp) int32 (tp-replicated)
    Sq_cols: Array,   # (B, Cp, block) int8: this rank's constraint cols
    gradcon_of,       # lanes -> (acc_blk (B, block), c_acc (B, Cp)), reduced
    c_acc_of,         # lanes -> c_acc (B, Cp), reduced
    *,
    outer: int,
    inners: int,
    g_shift: int,
    y_shift: int,
) -> Tuple[Array, Array]:
    """Column-sharded ALM iteration (the per-problem-operand form of
    parallel.solver.ShardedConstrainedPGD._local_solve).  ``gradcon_of``
    supplies the psum-reduced raw objective-gradient block and constraint
    accumulator; ``c_acc_of`` the constraint accumulator alone (the outer
    multiplier update).  The loop applies the 14-bit split penalty
    gradient with error feedback, the y backprop into this rank's
    columns and the saturating packed update."""
    lower = jnp.full((1,), _lower_words(), jnp.uint32)
    half = np.int32(1 << (g_shift - 1))
    y_half = np.int32((1 << y_shift) >> 1) if y_shift else np.int32(0)
    y_cap = np.int32((1 << _Y_BITS) - 1)

    def c_pre_of(lanes):
        return (c_acc_of(lanes) * cs_num[:, None]) >> cs_den[:, None]

    def inner(_, st):
        words, carry, ey, lam = st
        lanes = unpack_controls(words)                   # (B, block)
        acc_blk, c_acc = gradcon_of(lanes)
        pre = (acc_blk * hs_num[:, None]) >> hs_den[:, None]
        c_pre = (c_acc * cs_num[:, None]) >> cs_den[:, None]
        t = c_pre + c_off + lam
        y = t - jnp.clip(t, lo_pre, hi_pre) + ey
        y14 = jnp.clip((y + y_half) >> np.int32(y_shift), -y_cap, y_cap)
        ey = y - (y14 << np.int32(y_shift))
        y_hi = y14 >> np.int32(7)
        y_lo = y14 - (y_hi << np.int32(7))
        y_stack = jnp.stack(
            [y_hi.astype(jnp.int8), y_lo.astype(jnp.int8)], axis=1
        )  # (B, 2, Cp)
        acc_hl = jax.lax.dot_general(
            y_stack, Sq_cols,
            dimension_numbers=(((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, 2, block): our gradient columns, no collective
        extra = (
            (acc_hl[:, 0] * eh_num[:, None]) >> eh_den[:, None]
        ) + ((acc_hl[:, 1] * el_num[:, None]) >> el_den[:, None])
        step = -(pre + g_r + extra) + carry
        delta = jnp.clip((step + half) >> np.int32(g_shift), -128, 127)
        carry = step - (delta << np.int32(g_shift))
        words = W.add_signed_saturate(
            CONTROL_LAYOUT, words, pack_controls(delta)
        )
        words = W.max_signed(
            CONTROL_LAYOUT, words, jnp.broadcast_to(lower, words.shape)
        )
        return words, carry, ey, lam

    def outer_body(_, st):
        words, carry, ey, lam = st
        words, carry, ey, lam = jax.lax.fori_loop(
            0, inners, inner, (words, carry, ey, lam)
        )
        t = c_pre_of(unpack_controls(words)) + c_off + lam
        lam = jnp.clip(t - jnp.clip(t, lo_pre, hi_pre), -_LAM_CAP, _LAM_CAP)
        return words, carry, ey, lam

    carry0 = g_r ^ g_r
    ey0 = c_off ^ c_off
    words, _, _, lam = jax.lax.fori_loop(
        0, outer, outer_body, (u_words, carry0, ey0, lam0)
    )
    return words, lam


def _alm_batched_cols(
    u_words: Array,   # (B, block/4) uint32: this rank's iterate columns
    g_r: Array,       # (B, block) int32: this rank's linear-term columns
    Hq: Array,        # (B, Tp, Tp) int8 per-problem Hessian (tp-replicated)
    hs_num: Array,
    hs_den: Array,
    Sq: Array,        # (B, Cp, Tp) int8 constraint rows (tp-replicated)
    cs_num: Array,
    cs_den: Array,
    c_off: Array,     # (B, Cp) int32 (tp-replicated)
    lo_pre: Array,
    hi_pre: Array,
    eh_num: Array,
    eh_den: Array,
    el_num: Array,
    el_den: Array,
    lam0: Array,      # (B, Cp) int32 (tp-replicated)
    *,
    outer: int,
    inners: int,
    g_shift: int,
    y_shift: int,
    axis_name: str,
    block: int,
) -> Tuple[Array, Array]:
    """Column-sharded :func:`_alm_batched`: the horizon splits into
    ``block``-wide column blocks across mesh axis ``axis_name``.

    Per inner iteration: TWO exact int32 psums (objective gradient and
    constraint evaluation); the constraint-row plane (violations, error
    feedback, multipliers) is tp-replicated -- every rank recomputes it
    from the psum-reduced values with identical integer ops -- and the
    penalty-gradient matmul contracts over the full local row plane into
    only this rank's columns, collective-free."""
    r = jax.lax.axis_index(axis_name)
    Hq_cols = jax.lax.dynamic_slice_in_dim(Hq, r * block, block, axis=2)
    Sq_cols = jax.lax.dynamic_slice_in_dim(Sq, r * block, block, axis=2)

    def c_acc_of(lanes):
        partial = jax.lax.dot_general(
            lanes.astype(jnp.int8), Sq_cols,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, Cp): this rank's column contribution
        return jax.lax.psum(partial, axis_name)

    def gradcon_of(lanes):
        partial = jax.lax.dot_general(
            lanes.astype(jnp.int8), Hq_cols,
            dimension_numbers=(((1,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.int32,
        )  # (B, Tp)
        acc = jax.lax.psum(partial, axis_name)
        acc_blk = jax.lax.dynamic_slice_in_dim(
            acc, r * block, block, axis=1
        )
        return acc_blk, c_acc_of(lanes)

    return _alm_cols_loop(
        u_words, g_r, hs_num, hs_den, cs_num, cs_den, c_off, lo_pre,
        hi_pre, eh_num, eh_den, el_num, el_den, lam0, Sq_cols,
        gradcon_of, c_acc_of,
        outer=outer, inners=inners, g_shift=g_shift, y_shift=y_shift,
    )



@dataclasses.dataclass(frozen=True)
class ConstrainedSQP:
    """SQP trajectory optimizer with hard per-step state constraints
    ``lo <= F x_k <= hi`` (k = 1..T), on packed int8 plans.

    All objective fields mean what they do on :class:`QuantizedSQP`
    (composition: ``sqp`` carries the model/cost geometry); ``F`` is
    (Cs, n) over physical states, ``lo``/``hi`` scalar or (Cs,).  Per SQP
    iteration: linearize + condense (shared with the unconstrained path),
    stack constraint rows from the same propagators, quantize per problem,
    run ``alm_outer`` device multiplier updates x ``pgd_iters`` PGD inners.
    Multipliers persist across SQP iterations (rows keep their step-k
    meaning), which is what lets small per-iteration ALM budgets converge.
    """

    sqp: QuantizedSQP
    F: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([[0.0, 1.0, 0.0]])
    )
    lo: float | np.ndarray = -1.0
    hi: float | np.ndarray = 1.0
    rho: float = 50.0
    alm_outer: int = 3
    row_pad: int = 64

    @functools.cached_property
    def _F(self) -> np.ndarray:
        return np.atleast_2d(np.asarray(self.F, float))

    @functools.cached_property
    def _bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        Cs = self._F.shape[0]
        lo = np.broadcast_to(np.asarray(self.lo, float), (Cs,))
        hi = np.broadcast_to(np.asarray(self.hi, float), (Cs,))
        if np.any(lo >= hi):
            raise ValueError("state constraint lo must be < hi per row")
        T = self.sqp.horizon
        return np.tile(lo, T), np.tile(hi, T)

    @property
    def n_rows(self) -> int:
        return self._F.shape[0] * self.sqp.horizon

    @functools.cached_property
    def padded_rows(self) -> int:
        return -(-self.n_rows // self.row_pad) * self.row_pad

    def init_words(self, batch: int) -> Array:
        return self.sqp.init_words(batch)

    def init_lam(self, batch: int) -> Array:
        return jnp.zeros((batch, self.padded_rows), jnp.int32)

    # -- host-side per-iteration prep -----------------------------------------

    def _condense_constrained(self, x0_f: np.ndarray, lanes: np.ndarray):
        """Linearize/condense/stack/quantize for the whole batch.

        The objective half matches ``QuantizedSQP._condense_batch`` except
        alpha = 1/(lip + rho * penalty_lip); the constraint half is the
        batched form of ``quantize_constrained`` (mpc/constrained.py) in
        lane units (u_scale = 1, u_max = 127)."""
        s = self.sqp
        T, m = s.horizon, s.n_ctrl
        ls = s._lane_scales
        batch = x0_f.shape[0]
        u_phys = lanes.reshape(batch, T, m) * ls
        traj = s.model.reference_rollout(x0_f, u_phys)
        s._check_dims(traj.shape[-1])
        n = traj.shape[-1]
        if self._F.shape[1] != n:
            raise ValueError(
                f"F has {self._F.shape[1]} columns, state dim is {n}"
            )
        A_seq, B_seq = s.model.linearize(traj[:, :-1], u_phys)
        c_seq = (
            traj[:, 1:]
            - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
            - np.einsum("bkij,bkj->bki", B_seq, u_phys)
        )
        R_lane = ls[:, None] * np.asarray(s.R) * ls[None, :]
        H, G, g_ref, lip, Abar, Bbar, Cbar = condense_ltv_batch(
            A_seq, B_seq * ls, c_seq, np.asarray(s.Q), R_lane,
            s._Qf, np.asarray(s.x_ref, float), return_propagators=True,
        )
        Fm = self._F
        C, Tm, Tp, Cp = self.n_rows, T * m, s.padded, self.padded_rows
        S_b = np.einsum("ci,bkin->bkcn", Fm, Bbar).reshape(batch, C, Tm)
        P_b = np.einsum("ci,bkin->bkcn", Fm, Abar).reshape(batch, C, n)
        r_b = np.einsum("ci,bki->bkc", Fm, Cbar).reshape(batch, C)

        pen_lip = np.linalg.eigvalsh(
            S_b @ np.swapaxes(S_b, 1, 2)
        )[:, -1]
        alpha = 1.0 / (lip + self.rho * pen_lip)
        Hq, g_pre, hs_num, hs_den = quantize_batch(
            H, G, g_ref, alpha, x0_f, Tp, s.g_shift
        )

        # constraint quantization (per problem)
        s_scale = np.abs(S_b).max(axis=(1, 2)) / 127.0
        if (s_scale == 0).any():
            raise ValueError("constraint rows identically zero for a problem")
        Sq = np.zeros((batch, Cp, Tp), np.int8)
        Sq[:, :C, :Tm] = np.round(S_b / s_scale[:, None, None]).astype(
            np.int8
        )
        lo_r, hi_r = self._bounds
        row_amp = 127.0 * np.abs(S_b).sum(axis=2).max(axis=1)
        b_amp = float(max(np.abs(lo_r).max(), np.abs(hi_r).max()))
        c_unit = 2.0 * (row_amp + b_amp) / float(1 << _C_BITS)   # (B,)

        cs_num, cs_den = _rational_vec(
            s_scale / c_unit, 127 * 127 * Tp, 2**31 - 1, "cs"
        )
        base = (
            self.rho * s_scale * float(1 << _Y_SHIFT) * c_unit * alpha
        ) * float(1 << s.g_shift)
        eh_num, eh_den = _rational_vec(
            base * 128.0, 64 * 127 * Cp, 2**30 - 1, "eh"
        )
        el_num, el_den = _rational_vec(
            base, 127 * 127 * Cp, 2**30 - 1, "el"
        )

        sent = np.int32(1 << 30)
        lo_pre = np.full((batch, Cp), -sent, np.int32)
        hi_pre = np.full((batch, Cp), sent, np.int32)
        lo_pre[:, :C] = np.clip(
            np.round(lo_r / c_unit[:, None]), -sent, sent
        )
        hi_pre[:, :C] = np.clip(
            np.round(hi_r / c_unit[:, None]), -sent, sent
        )
        off = np.einsum("bn,bcn->bc", x0_f, P_b) + r_b
        off = np.nan_to_num(
            off / c_unit[:, None], posinf=_CX0_CAP, neginf=-_CX0_CAP
        )
        c_off = np.zeros((batch, Cp), np.int32)
        c_off[:, :C] = np.clip(np.round(off), -_CX0_CAP, _CX0_CAP)
        return dict(
            Hq=Hq, g_pre=g_pre, hs_num=hs_num, hs_den=hs_den, Sq=Sq,
            cs_num=cs_num, cs_den=cs_den, c_off=c_off, lo_pre=lo_pre,
            hi_pre=hi_pre, eh_num=eh_num, eh_den=eh_den, el_num=el_num,
            el_den=el_den,
        ), c_unit

    # -- public API ------------------------------------------------------------

    def solve(
        self,
        x0_f: np.ndarray,
        u_words: Optional[Array] = None,
        lam: Optional[Array] = None,
        track_costs: bool = True,
    ):
        """Run ``sqp.sqp_iters`` outer SQP iterations with the constrained
        inner solve.  Returns (words, lam, cost history or None)."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        s = self.sqp
        if u_words is None:
            u_words = self.init_words(batch)
        if lam is None:
            lam = self.init_lam(batch)
        costs = (
            [s.true_cost(x0_f, s.lanes(u_words))] if track_costs else None
        )
        prev_c_unit = None
        for _ in range(s.sqp_iters):
            ops, c_unit = self._condense_constrained(x0_f, s.lanes(u_words))
            if prev_c_unit is not None:
                # the multiplier plane lives in c-pre units; relinearization
                # changes the per-problem c_unit, so carried multipliers are
                # rescaled to keep their physical value lam_pre * c_unit
                lam_np = np.asarray(lam, np.int64)
                lam_np = np.clip(
                    np.round(lam_np * (prev_c_unit / c_unit)[:, None]),
                    -int(_LAM_CAP),
                    int(_LAM_CAP),
                ).astype(np.int32)
                lam = jnp.asarray(lam_np)
            prev_c_unit = c_unit
            u_words, lam = _alm_batched(
                u_words,
                *(
                    jnp.asarray(ops[k])
                    for k in (
                        "g_pre", "Hq", "hs_num", "hs_den", "Sq", "cs_num",
                        "cs_den", "c_off", "lo_pre", "hi_pre", "eh_num",
                        "eh_den", "el_num", "el_den",
                    )
                ),
                lam,
                outer=self.alm_outer,
                inners=s.pgd_iters,
                g_shift=s.g_shift,
                y_shift=_Y_SHIFT,
            )
            if track_costs:
                costs.append(s.true_cost(x0_f, s.lanes(u_words)))
        return u_words, lam, (
            np.stack(costs, axis=-1) if track_costs else None
        )

    # -- diagnostics -------------------------------------------------------------

    def constraint_trajectory(
        self, x0_f: np.ndarray, lanes: np.ndarray
    ) -> np.ndarray:
        """True (nonlinear-rollout) constraint values F x_k, (B, T, Cs):
        the feasibility check is on the real trajectory, not the
        linearization."""
        s = self.sqp
        u_phys = (
            lanes.reshape(-1, s.horizon, s.n_ctrl) * s._lane_scales
        )
        traj = s.model.reference_rollout(np.atleast_2d(x0_f), u_phys)
        return np.einsum("ci,bki->bkc", self._F, traj[:, 1:])

    def violation(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Max true-trajectory constraint violation per problem."""
        c = self.constraint_trajectory(x0_f, lanes)
        Cs = self._F.shape[0]
        lo = np.asarray(self._bounds[0]).reshape(-1, Cs)[0]
        hi = np.asarray(self._bounds[1]).reshape(-1, Cs)[0]
        return np.maximum(
            np.maximum(c - hi, 0), np.maximum(lo - c, 0)
        ).max(axis=(1, 2))

    # -- float64 reference (same algorithm, no quantization) --------------------

    def reference_solve(self, x0_f: np.ndarray):
        """Float64 SQP+ALM with the identical structure: per SQP iteration,
        linearize/condense/stack, then ``alm_outer`` x ``pgd_iters``
        projected-gradient inners with projection-form multiplier updates.
        Returns (lane plans (B, n_dec) float64, lam (B, C))."""
        s = self.sqp
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float64))
        batch = x0_f.shape[0]
        T, m = s.horizon, s.n_ctrl
        ls = s._lane_scales
        lo_r, hi_r = self._bounds
        U = np.zeros((batch, s.n_dec))
        lam = np.zeros((batch, self.n_rows))
        for _ in range(s.sqp_iters):
            u_phys = U.reshape(batch, T, m) * ls
            traj = s.model.reference_rollout(x0_f, u_phys)
            A_seq, B_seq = s.model.linearize(traj[:, :-1], u_phys)
            c_seq = (
                traj[:, 1:]
                - np.einsum("bkij,bkj->bki", A_seq, traj[:, :-1])
                - np.einsum("bkij,bkj->bki", B_seq, u_phys)
            )
            R_lane = ls[:, None] * np.asarray(s.R) * ls[None, :]
            H, G, g_ref, lip, Abar, Bbar, Cbar = condense_ltv_batch(
                A_seq, B_seq * ls, c_seq, np.asarray(s.Q), R_lane,
                s._Qf, np.asarray(s.x_ref, float),
                return_propagators=True,
            )
            Fm = self._F
            n = traj.shape[-1]
            C = self.n_rows
            S_b = np.einsum("ci,bkin->bkcn", Fm, Bbar).reshape(
                batch, C, s.n_dec
            )
            P_b = np.einsum("ci,bkin->bkcn", Fm, Abar).reshape(batch, C, n)
            r_b = np.einsum("ci,bki->bkc", Fm, Cbar).reshape(batch, C)
            pen_lip = np.linalg.eigvalsh(
                S_b @ np.swapaxes(S_b, 1, 2)
            )[:, -1]
            alpha = 1.0 / (lip + self.rho * pen_lip)
            g0 = np.einsum("bin,bn->bi", G, x0_f) + g_ref
            cx0 = np.einsum("bn,bcn->bc", x0_f, P_b) + r_b
            for _ in range(self.alm_outer):
                for _ in range(s.pgd_iters):
                    t = (
                        np.einsum("bcn,bn->bc", S_b, U)
                        + cx0
                        + lam / self.rho
                    )
                    y = t - np.clip(t, lo_r, hi_r)
                    grad = (
                        np.einsum("bij,bj->bi", H, U)
                        + g0
                        + self.rho * np.einsum("bc,bcn->bn", y, S_b)
                    )
                    U = np.clip(U - alpha[:, None] * grad, -127.0, 127.0)
                t = (
                    np.einsum("bcn,bn->bc", S_b, U)
                    + cx0
                    + lam / self.rho
                )
                lam = self.rho * (t - np.clip(t, lo_r, hi_r))
        return U, lam
