"""Device-resident state-constrained SQP: nonlinear MPC with hard
``lo <= F x_k <= hi`` entirely on the device.

:class:`~pint_jax.mpc.sqp_constrained.ConstrainedSQP` re-linearizes,
re-stacks and re-quantizes on host (float64 numpy) every SQP iteration --
oracle-grade accuracy, host-bound throughput.  :class:`DeviceConstrainedSQP`
moves the WHOLE constrained loop into one jitted XLA program, composing the
two fast tiers of this package:

* the batch-last tiled condensation of :class:`~pint_jax.mpc.device_sqp.
  DeviceSQP` (propagate scan + reduce + power-iteration Lipschitz +
  on-device int8 quantization -- docs/DESIGN.md section 8),
* the batched integer ALM inner of :func:`~pint_jax.mpc.sqp_constrained.
  _alm_batched` (per-problem int8 Hessians AND constraint rows, split
  14-bit penalty gradient with error feedback, exact int32 multiplier
  updates).

Per SQP outer iteration, all on device: f32 rollout + linearization around
the current packed plan, condensation to (H, g), constraint-row stacking
S = F Bbar / P = F Abar / r = F Cbar from the same batch-last propagator
stacks, a second power iteration for the penalty Lipschitz lambda_max(S S^T),
int8/rational quantization of both the objective and the constraint rows,
multiplier rescale across relinearizations (the lam plane lives in c-pre
units whose per-problem scale moves with the trajectory), and
``alm_outer x pgd_iters`` integer ALM inners.

Everything is static-shaped; one compile serves every batch of the same
geometry, and the program is vmap/shard_map-batchable like every other
solver here.  Quantization rationals are computed with the same traced
exp2/log2 discipline as :meth:`DeviceSQP._quantize_phase` (f32 mantissa
error lands orders of magnitude below the int8 rounding it feeds).

No counterpart in the reference library (SURVEY.md section 2.4): this is
BASELINE.json capability layer ("full fixed-point MPC: box-constrained
condensed QP + saturating control update").  Packed-word machinery
exercised per inner iteration: add_signed_saturate (pint.hpp:857-866),
max_signed (pint.hpp:987-1004), pack/unpack (pint.hpp:390-407, 799-822).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.mpc.constrained import _C_BITS, _CX0_CAP, _LAM_CAP
from pint_jax.mpc.device_sqp import DeviceSQP, _fold_dot, _fold_sum
from pint_jax.mpc.sqp_constrained import _Y_SHIFT, _alm_batched, _alm_batched_cols
from pint_jax.models.dynamics import unpack_controls

Array = jax.Array

__all__ = ["DeviceConstrainedSQP"]


def _rational_traced(
    val: Array, acc_max: int, budget: int
) -> Tuple[Array, Array]:
    """Traced int32 rational num/2**den ~ val (the on-device form of
    sqp_constrained._rational_vec; no validation raises -- degenerate
    scales are the caller's documented precondition, as in
    DeviceSQP._quantize_phase)."""
    num_max = np.float32(budget // acc_max)
    den = jnp.clip(
        jnp.floor(jnp.log2(num_max / val)), 0, 31
    ).astype(jnp.int32)
    num = jnp.round(val * jnp.exp2(den.astype(jnp.float32))).astype(
        jnp.int32
    )
    return num, den


@dataclasses.dataclass(frozen=True)
class DeviceConstrainedSQP:
    """On-device SQP with hard per-step state constraints on packed plans.

    ``dev`` carries the model/cost geometry (:class:`DeviceSQP`; its
    ``sqp_iters``/``pgd_iters`` mean SQP outers / ALM inner PGD steps
    here); ``F`` is (Cs, n) over physical states, ``lo``/``hi`` scalar or
    (Cs,), enforced at every step k = 1..T of the linearized trajectory
    (feasibility is checked against the true nonlinear rollout in tests).
    """

    dev: DeviceSQP = dataclasses.field(default_factory=DeviceSQP)
    F: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([[0.0, 1.0, 0.0]])
    )
    lo: "float | np.ndarray" = -1.0
    hi: "float | np.ndarray" = 1.0
    rho: float = 50.0
    alm_outer: int = 3
    row_pad: int = 64
    @functools.cached_property
    def _sharded_cache(self) -> dict:
        return {}

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
        T = self.dev.horizon
        return np.tile(lo, T), np.tile(hi, T)

    @property
    def n_rows(self) -> int:
        return self._F.shape[0] * self.dev.horizon

    @functools.cached_property
    def padded_rows(self) -> int:
        return -(-self.n_rows // self.row_pad) * self.row_pad

    def init_words(self, batch: int) -> Array:
        return self.dev.init_words(batch)

    def init_lam(self, batch: int) -> Array:
        return jnp.zeros((batch, self.padded_rows), jnp.int32)

    # -- on-device condensation + constraint stacking ---------------------------

    def _stack_constraints(self, Abar: Array, Bbar_all: Array, Cbar: Array):
        """Constraint stacks from the batch-last propagators: row k*Cs+c is
        constraint c at step k+1.  Returns S_t (C,Tm,B), P_t (C,n,B),
        r_t (C,B) -- batch-last like everything upstream."""
        Tm = self.dev.n_dec
        C = self.n_rows
        Fj = jnp.asarray(self._F, jnp.float32)[None]          # (1, Cs, n)
        S_t = _fold_dot(Bbar_all[:, None], Fj[..., None, None], axis=2)
        S_t = S_t.reshape(C, Tm, -1)
        P_t = _fold_dot(Abar[:, None], Fj[..., None, None], axis=2)
        P_t = P_t.reshape(C, Abar.shape[2], -1)               # (C, n, B)
        r_t = _fold_dot(Cbar[:, None], Fj[..., None], axis=2).reshape(C, -1)
        return S_t, P_t, r_t

    def _pen_lipschitz(self, S_t: Array) -> Array:
        """Power iteration for lambda_max(S S^T) per problem (equals
        lambda_max(S^T S)); same batch-last zero-padding discipline and
        1.05 safety factor as DeviceSQP._lipschitz_phase."""
        Tm = S_t.shape[1]

        def pit(_, v):                                        # v (Tm, B)
            w = _fold_dot(S_t, v[None], axis=1)               # (C, B)
            u = _fold_dot(S_t, w[:, None])                    # (Tm, B)
            return u / (jnp.sqrt(_fold_dot(u, u)) + 1e-30)

        zero_b = (S_t[0, 0] * 0.0).astype(jnp.float32)        # (B,)
        v0 = jnp.full((Tm, 1), 1.0 / np.sqrt(Tm), jnp.float32) + zero_b
        v = jax.lax.fori_loop(0, self.dev.power_iters, pit, v0)
        w = _fold_dot(S_t, v[None], axis=1)
        hv = _fold_dot(S_t, w[:, None])
        return _fold_dot(v, hv) * np.float32(1.05)

    def _condense_constrained_dev(self, x0_f: Array, lanes: Array):
        """Full traced per-iteration prep: linearize, condense, stack,
        quantize objective + constraints.  Returns (ops dict, c_unit (B,)
        f32)."""
        d = self.dev
        Tp = d.n_dec
        C, Cp = self.n_rows, self.padded_rows

        A_seq, B_lane, c_seq = d._linearize_phase(x0_f, lanes)
        Abar, Bbar_all, Cbar = d._propagate_scan(A_seq, B_lane, c_seq)
        Ht, g = d._reduce(Abar, Bbar_all, Cbar, x0_f)
        S_t, P_t, r_t = self._stack_constraints(Abar, Bbar_all, Cbar)
        # pin every f32 reduction output before anything rounds on it, so
        # the reductions compile the same whatever consumes them (see
        # DeviceSQP._condense_dev)
        Ht, g, S_t, P_t, r_t = jax.lax.optimization_barrier(
            (Ht, g, S_t, P_t, r_t)
        )
        lip = d._lipschitz_phase(Ht)
        pen_lip = self._pen_lipschitz(S_t)
        lip, pen_lip = jax.lax.optimization_barrier((lip, pen_lip))
        # alpha = 1 / (lip + rho * pen_lip): reuse the objective
        # quantizer with the combined curvature as its "lip"
        lip_total = lip + np.float32(self.rho) * pen_lip
        Hq, g_pre, hs_num, hs_den = d._quantize_phase(Ht, g, lip_total)
        alpha = 1.0 / lip_total                               # (B,)

        # constraint quantization, the traced mirror of
        # ConstrainedSQP._condense_constrained (sqp_constrained.py)
        s_scale = jnp.max(jnp.abs(S_t), axis=(0, 1)) / 127.0  # (B,)
        Sq_t = jnp.clip(
            jnp.round(S_t / s_scale[None, None, :]), -127, 127
        ).astype(jnp.int8)                                    # (C, Tm, B)
        Sq = jnp.transpose(Sq_t, (2, 0, 1))                   # (B, C, Tm)
        if Cp > C:
            Sq = jnp.pad(Sq, ((0, 0), (0, Cp - C), (0, 0)))
        row_amp = 127.0 * jnp.max(
            _fold_sum(jnp.abs(S_t), axis=1), axis=0
        )                                                     # (B,)
        row_amp = jax.lax.optimization_barrier(row_amp)
        lo_r, hi_r = self._bounds
        b_amp = np.float32(max(np.abs(lo_r).max(), np.abs(hi_r).max()))
        c_unit = 2.0 * (row_amp + b_amp) / np.float32(1 << _C_BITS)

        cs_num, cs_den = _rational_traced(
            s_scale / c_unit, 127 * 127 * Tp, 2**31 - 1
        )
        base = (
            np.float32(self.rho)
            * s_scale
            * np.float32(1 << _Y_SHIFT)
            * c_unit
            * alpha
        ) * np.float32(1 << d.g_shift)
        eh_num, eh_den = _rational_traced(
            base * 128.0, 64 * 127 * Cp, 2**30 - 1
        )
        el_num, el_den = _rational_traced(base, 127 * 127 * Cp, 2**30 - 1)

        sent = np.int32(1 << 30)
        lo_pre_rows = jnp.clip(
            jnp.round(
                jnp.asarray(lo_r, jnp.float32)[None, :] / c_unit[:, None]
            ),
            -sent, sent,
        ).astype(jnp.int32)                                   # (B, C)
        hi_pre_rows = jnp.clip(
            jnp.round(
                jnp.asarray(hi_r, jnp.float32)[None, :] / c_unit[:, None]
            ),
            -sent, sent,
        ).astype(jnp.int32)
        pad_cols = Cp - C
        lo_pre = jnp.pad(
            lo_pre_rows, ((0, 0), (0, pad_cols)), constant_values=-sent
        )
        hi_pre = jnp.pad(
            hi_pre_rows, ((0, 0), (0, pad_cols)), constant_values=sent
        )
        # constant offset rows: c_off = (x0 . P + r) / c_unit
        x0t = jnp.transpose(x0_f.astype(jnp.float32))         # (n, B)
        off = jnp.transpose(_fold_dot(P_t, x0t[None], axis=1) + r_t)
        off = jax.lax.optimization_barrier(off)
        off = jnp.nan_to_num(
            off / c_unit[:, None], posinf=_CX0_CAP, neginf=-_CX0_CAP
        )
        c_off = jnp.clip(
            jnp.round(off), -_CX0_CAP, _CX0_CAP
        ).astype(jnp.int32)
        c_off = jnp.pad(c_off, ((0, 0), (0, pad_cols)))
        ops = dict(
            g_pre=g_pre, hs_num=hs_num, hs_den=hs_den,
            cs_num=cs_num, cs_den=cs_den, c_off=c_off, lo_pre=lo_pre,
            hi_pre=hi_pre, eh_num=eh_num, eh_den=eh_den, el_num=el_num,
            el_den=el_den, Hq=Hq, Sq=Sq,
        )
        # barrier the quantized operands too, so the consumer cannot pull
        # the rounding chain into a differently-compiled fusion
        return jax.lax.optimization_barrier((ops, c_unit))

    # -- public API --------------------------------------------------------------

    def _run_inner(self, words, ops, lam):
        """The XLA integer ALM inner on the quantized operands."""
        d = self.dev
        return _alm_batched(
            words, ops["g_pre"], ops["Hq"], ops["hs_num"], ops["hs_den"],
            ops["Sq"], ops["cs_num"], ops["cs_den"], ops["c_off"],
            ops["lo_pre"], ops["hi_pre"], ops["eh_num"], ops["eh_den"],
            ops["el_num"], ops["el_den"], lam,
            outer=self.alm_outer, inners=d.pgd_iters,
            g_shift=d.g_shift, y_shift=_Y_SHIFT,
        )

    @functools.cached_property
    def _solve_jit(self):
        d = self.dev

        def solve(u_words: Array, x0_f: Array, lam0: Array):
            def outer(k, st):
                words, lam, prev_cu = st
                lanes = unpack_controls(words)[:, : d.n_dec]
                ops, c_unit = self._condense_constrained_dev(x0_f, lanes)
                # multipliers live in c-pre units; relinearization moves
                # the per-problem c_unit, so carried lam is rescaled to
                # keep its physical value lam_pre * c_unit (no-op on the
                # first iteration, where prev_cu enters as c_unit-sized
                # garbage guarded by k == 0)
                scale = jnp.where(
                    k > 0, prev_cu / c_unit, jnp.ones_like(c_unit)
                )
                lam = jnp.clip(
                    jnp.round(lam.astype(jnp.float32) * scale[:, None]),
                    -float(_LAM_CAP), float(_LAM_CAP),
                ).astype(jnp.int32)
                words, lam = self._run_inner(words, ops, lam)
                return words, lam, c_unit

            # derive from the device-varying input so the carry's sharding
            # axes match under shard_map (a bare zeros would be replicated)
            cu0 = (x0_f[:, 0] * 0.0).astype(jnp.float32)
            words, lam, _ = jax.lax.fori_loop(
                0, d.sqp_iters, outer, (u_words, lam0, cu0)
            )
            return words, lam

        return jax.jit(solve)

    def solve_words(
        self,
        u_words: Array,
        x0_f: Array,
        lam: Optional[Array] = None,
    ) -> Tuple[Array, Array]:
        """``dev.sqp_iters`` on-device constrained SQP iterations.

        x0_f (B, n) float32 physical state; u_words (B, Tm/4) packed int8
        plan (warm start); lam (B, padded_rows) int32 multipliers (zeros
        when omitted).  Returns (words, lam) -- pass both back in for
        warm-started receding-horizon use.  One XLA program.
        """
        x0j = jnp.asarray(x0_f, jnp.float32)
        if self._F.shape[1] != x0j.shape[-1]:
            raise ValueError(
                f"F has {self._F.shape[1]} columns, state dim is "
                f"{x0j.shape[-1]}"
            )
        if u_words.shape[0] != x0j.shape[0]:
            raise ValueError(
                f"u_words batch {u_words.shape[0]} != x0 batch "
                f"{x0j.shape[0]}"
            )
        if lam is None:
            lam = self.init_lam(x0j.shape[0])
        elif lam.shape != (x0j.shape[0], self.padded_rows):
            raise ValueError(
                f"lam shape {lam.shape} != "
                f"({x0j.shape[0]}, {self.padded_rows})"
            )
        return self._solve_jit(u_words, x0j, lam)

    def sharded_solve_words(self, mesh):
        """dp x tp sharded constrained solve: jitted (u_words (B, Tm/4)
        P('dp','tp'), x0_f (B, n) P('dp', None), lam (B, Cp)
        P('dp', None)) -> (words P('dp','tp'), lam P('dp', None)).

        **dp** shards problems.  **tp** shards the ALM inner's horizon
        columns: per inner iteration each rank contributes its column
        block to two exact int32 psums (objective gradient + constraint
        evaluation) while the constraint-row plane stays tp-replicated
        (:func:`~pint_jax.mpc.sqp_constrained._alm_batched_cols`).  Per
        SQP outer one int32 all_gather rebuilds the lane plan and the f32
        condensation + quantization run tp-replicated.  Bit-identical to
        :meth:`solve_words` on the whole batch, on every mesh shape
        (tests/test_device_constrained.py; on four H100s,
        ``chip_smoke.py --four-cards``).
        Programs are memoized per mesh (shape + device ids).
        """
        from jax.sharding import PartitionSpec as P

        d = self.dev
        key = d._mesh_key(mesh)
        cached = self._sharded_cache.get(key)
        if cached is not None:
            return cached
        tp = mesh.shape["tp"]
        if d.n_dec % (4 * tp):
            raise ValueError(
                f"horizon*n_ctrl = {d.n_dec} must divide into 4-lane "
                f"words across tp={tp}"
            )
        block = d.n_dec // tp

        def local(u_words: Array, x0_f: Array, lam0: Array):
            r = jax.lax.axis_index("tp")
            # the all_gathered lanes are device-varying over tp; mark the
            # tp-replicated inputs the same way or scan carries clash
            x0_f = jax.lax.pcast(x0_f, ("tp",), to="varying")
            lam0 = jax.lax.pcast(lam0, ("tp",), to="varying")

            def outer(k, st):
                words, lam, prev_cu = st
                lanes_r = unpack_controls(words)
                lanes = jax.lax.all_gather(
                    lanes_r, "tp", axis=1, tiled=True
                )  # (B_loc, Tm): exact int32 plan, tp-replicated
                ops, c_unit = self._condense_constrained_dev(x0_f, lanes)
                scale = jnp.where(
                    k > 0, prev_cu / c_unit, jnp.ones_like(c_unit)
                )
                lam = jnp.clip(
                    jnp.round(lam.astype(jnp.float32) * scale[:, None]),
                    -float(_LAM_CAP), float(_LAM_CAP),
                ).astype(jnp.int32)
                g_r = jax.lax.dynamic_slice_in_dim(
                    ops["g_pre"], r * block, block, axis=1
                )
                words, lam = _alm_batched_cols(
                    words, g_r, ops["Hq"], ops["hs_num"], ops["hs_den"],
                    ops["Sq"], ops["cs_num"], ops["cs_den"], ops["c_off"],
                    ops["lo_pre"], ops["hi_pre"], ops["eh_num"],
                    ops["eh_den"], ops["el_num"], ops["el_den"], lam,
                    outer=self.alm_outer, inners=d.pgd_iters,
                    g_shift=d.g_shift, y_shift=_Y_SHIFT,
                    axis_name="tp", block=block,
                )
                return words, lam, c_unit

            cu0 = (x0_f[:, 0] * 0.0).astype(jnp.float32)
            words, lam, _ = jax.lax.fori_loop(
                0, d.sqp_iters, outer, (u_words, lam0, cu0)
            )
            # lam is value-identical on every tp rank (all its inputs are
            # psum-reduced or replicated) but MARKED varying by the pcast
            # above; re-replicate exactly by psumming rank 0's copy so the
            # P('dp', None) out_spec type-checks
            lam = jax.lax.psum(
                jnp.where(r == 0, lam, jnp.zeros_like(lam)), "tp"
            )
            return words, lam

        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P("dp", "tp"), P("dp", None), P("dp", None)),
            out_specs=(P("dp", "tp"), P("dp", None)),
        )
        out = jax.jit(
            lambda u, x0, lam: fn(u, jnp.asarray(x0, jnp.float32), lam)
        )
        self._sharded_cache[key] = out
        return out

    def solve(self, x0_f: np.ndarray):
        """Cold-start convenience (API symmetry with DeviceSQP.solve):
        returns (words, lam, physical plans (B, T, m))."""
        x0_f = np.atleast_2d(np.asarray(x0_f, np.float32))
        d = self.dev
        words, lam = self.solve_words(
            self.init_words(x0_f.shape[0]), x0_f
        )
        lanes = np.asarray(unpack_controls(words))[:, : d.n_dec]
        plans = (
            lanes.reshape(-1, d.horizon, d.n_ctrl) * d._lane_scales
        )
        return words, lam, plans

    # -- diagnostics (host-side, match ConstrainedSQP) ---------------------------

    def violation(self, x0_f: np.ndarray, lanes: np.ndarray) -> np.ndarray:
        """Max true-trajectory (f32 rollout) constraint violation per
        problem."""
        d = self.dev
        u_phys = jnp.asarray(
            lanes.reshape(-1, d.horizon, d.n_ctrl) * d._lane_scales,
            jnp.float32,
        )
        traj = d.model.rollout_f32(
            jnp.asarray(np.atleast_2d(x0_f), jnp.float32), u_phys
        )
        c = np.einsum("ci,bki->bkc", self._F, np.asarray(traj[:, 1:]))
        Cs = self._F.shape[0]
        lo = np.asarray(self._bounds[0]).reshape(-1, Cs)[0]
        hi = np.asarray(self._bounds[1]).reshape(-1, Cs)[0]
        return np.maximum(
            np.maximum(c - hi, 0), np.maximum(lo - c, 0)
        ).max(axis=(1, 2))
