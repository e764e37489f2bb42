"""Mesh-sharded fixed-point MPC solver (dp x tp, shard_map + psum).

Distribution plan (BASELINE.json: "condensed-QP residual/gradient blocks
reduced via psum/all-reduce"):

* **dp** shards the problem batch; no cross-device traffic in the solve.
* **tp** shards the condensed horizon dimension ``Tp``.  Every device holds
  the column-block ``Hq[:, cols_r]`` of the int8 Hessian and the iterate
  block ``U[:, cols_r]`` (as packed words).  One PGD iteration:

      partial_r = U_r @ Hq[:, cols_r]^T          (B_loc, Tp)  int32
      acc      = psum(partial_r, 'tp')           full gradient
      step_r   = -(acc[:, cols_r]*hs + g_r)      local column block
      U_r     <- max_signed(add_signed_saturate(U_r, pack(step_r)), floor)

  The psum of int32 partials is bit-exact and associative, so the
  distributed solve is *deterministic* and identical to the single-device
  result (tested in tests/test_parallel.py).

The whole iteration loop runs inside one `shard_map` region, so XLA sees a
static loop of matmul+psum and can schedule the collective permutes onto ICI
without host round-trips.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pint_jax.models.dynamics import CONTROL_LAYOUT, pack_controls, unpack_controls
from pint_jax.mpc.condensed import QuantizedQP
from pint_jax.ops import word as W

shard_map = jax.shard_map

Array = jax.Array

__all__ = ["ShardedPGD", "ShardedConstrainedPGD"]


@dataclasses.dataclass(frozen=True)
class ShardedPGD:
    """dp x tp sharded PGD solver for one quantized QP."""

    qqp: QuantizedQP
    mesh: Mesh
    iters: int = 40
    momentum: bool = False
    """Nesterov extrapolation (see mpc/accelerated.py): the second iterate
    plane shards exactly like the first; bit-identical to AcceleratedPGD."""
    beta_den: int = 8

    def __post_init__(self):
        tp = self.mesh.shape["tp"]
        if self.qqp.padded % (4 * tp):
            raise ValueError(
                f"padded horizon {self.qqp.padded} must divide into "
                f"4-lane words across tp={tp}"
            )

    @functools.cached_property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @functools.cached_property
    def block(self) -> int:
        """Horizon lanes per tp rank."""
        return self.qqp.padded // self.tp

    @property
    def Hq_dev(self) -> Array:
        return jnp.asarray(self.qqp.Hq)  # (Tp, Tp) int8

    @property
    def lower_words(self) -> Array:
        w = 0
        for off in CONTROL_LAYOUT.offsets:
            w |= (-127 & 0xFF) << off
        return jnp.full((1,), np.uint32(w), jnp.uint32)

    # -- the shard-local iteration ------------------------------------------

    def _local_iterate(self, u_words: Array, g_pre: Array, Hq_cols: Array):
        """One PGD step on this rank's (B_loc, block) column block.

        u_words: (B_loc, block/4) uint32; g_pre: (B_loc, block) int32;
        Hq_cols: (Tp, block) int8 -- our columns of Hq.
        """
        lanes = unpack_controls(u_words)  # (B_loc, block) int32
        partial = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            Hq_cols,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (B_loc, Tp): contribution of our U block to every gradient row
        acc = jax.lax.psum(partial, "tp")  # full gradient, exact int32
        r = jax.lax.axis_index("tp")
        acc_blk = jax.lax.dynamic_slice_in_dim(
            acc, r * self.block, self.block, axis=1
        )
        pre = (acc_blk * np.int32(self.qqp.hs_num)) >> np.int32(self.qqp.hs_den)
        step = -(pre + g_pre)
        half = np.int32(1 << (self.qqp.g_shift - 1))
        delta = jnp.clip((step + half) >> np.int32(self.qqp.g_shift), -128, 127)
        u_words = W.add_signed_saturate(
            CONTROL_LAYOUT, u_words, pack_controls(delta)
        )
        u_words = W.max_signed(
            CONTROL_LAYOUT,
            u_words,
            jnp.broadcast_to(self.lower_words, u_words.shape),
        )
        return u_words

    @functools.cached_property
    def _beta_num(self) -> int:
        eig = np.linalg.eigvalsh(self.qqp.qp.H)
        kappa = float(eig.max() / max(eig.min(), 1e-12))
        rk = np.sqrt(kappa)
        return int(round((rk - 1.0) / (rk + 1.0) * (1 << self.beta_den)))

    def _local_solve(self, u_words: Array, g_pre: Array, Hq: Array):
        r = jax.lax.axis_index("tp")
        Hq_cols = jax.lax.dynamic_slice_in_dim(
            Hq, r * self.block, self.block, axis=1
        )

        if self.momentum:
            bnum = np.int32(self._beta_num)
            bden = np.int32(self.beta_den)

            def mbody(_, carry):
                x_words, xp_words = carry
                x = unpack_controls(x_words)
                xp = unpack_controls(xp_words)
                y = jnp.clip(x + ((bnum * (x - xp)) >> bden), -127, 127)
                y_words = pack_controls(y)
                return (
                    self._local_iterate(y_words, g_pre, Hq_cols),
                    x_words,
                )

            u_words, _ = jax.lax.fori_loop(
                0, self.iters, mbody, (u_words, u_words)
            )
        else:

            def body(_, u):
                return self._local_iterate(u, g_pre, Hq_cols)

            u_words = jax.lax.fori_loop(0, self.iters, body, u_words)
        # residual diagnostic: global L1 of the final gradient block,
        # reduced over BOTH mesh axes (the "residual blocks reduced via
        # psum" path of BASELINE.json)
        lanes = unpack_controls(u_words)
        partial = jax.lax.dot_general(
            lanes.astype(jnp.int8),
            Hq_cols,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = jax.lax.psum(partial, "tp")
        r_blk = jax.lax.dynamic_slice_in_dim(acc, r * self.block, self.block, 1)
        pre = (r_blk * np.int32(self.qqp.hs_num)) >> np.int32(self.qqp.hs_den)
        grad = pre + g_pre
        residual = jax.lax.psum(
            jnp.sum(jnp.abs(grad).astype(jnp.float32)), ("dp", "tp")
        )
        return u_words, residual

    # -- public API ---------------------------------------------------------

    @functools.cached_property
    def solve_words(self):
        """jitted (u_words (B, Tp/4), g_pre (B, Tp)) -> (words, residual),
        sharded dp over batch and tp over horizon."""
        fn = shard_map(
            self._local_solve,
            mesh=self.mesh,
            in_specs=(P("dp", "tp"), P("dp", "tp"), P(None, None)),
            out_specs=(P("dp", "tp"), P()),
        )
        return jax.jit(
            lambda u, g: fn(u, g, self.Hq_dev)
        )

    def init_words(self, batch: int) -> Array:
        sharding = NamedSharding(self.mesh, P("dp", "tp"))
        return jax.device_put(
            jnp.zeros((batch, self.qqp.padded // 4), jnp.uint32), sharding
        )

    def place_g(self, g_pre: np.ndarray) -> Array:
        sharding = NamedSharding(self.mesh, P("dp", "tp"))
        return jax.device_put(jnp.asarray(g_pre), sharding)

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array, Array]:
        """End-to-end sharded solve; returns (words, u_phys, residual)."""
        g_pre = self.place_g(self.qqp.g_lane_fixed(np.atleast_2d(x0_phys)))
        u0 = self.init_words(g_pre.shape[0])
        words, residual = self.solve_words(u0, g_pre)
        lanes = unpack_controls(words)[:, : self.qqp.horizon]
        return (
            words,
            lanes.astype(jnp.float32) * np.float32(self.qqp.u_scale),
            residual,
        )


@dataclasses.dataclass(frozen=True)
class ShardedConstrainedPGD:
    """dp x tp sharded augmented-Lagrangian solver (hard state constraints).

    The mesh extension of :class:`pint_jax.mpc.constrained.ConstrainedPGD`:
    **dp** shards the problem batch, **tp** shards the condensed horizon.
    Per inner iteration each rank contributes its column block to TWO exact
    int32 psums -- the objective gradient (``U_r @ Hq[:, cols_r]^T``) and
    the constraint evaluation (``U_r @ Sq[:, cols_r]^T``) -- while the
    constraint-row plane (violations, error feedback, multipliers) is
    tp-replicated: every rank recomputes it from the psum-reduced
    constraint values with identical integer ops, so no second collective
    is needed.  The penalty-gradient matmuls ``y @ Sq[:, cols_r]``
    contract over the full (local) row plane and are collective-free.

    Associativity of wrapping int32 addition makes the psums bit-exact, so
    the solve is *bit-identical* to the single-device ConstrainedPGD on
    every mesh shape (tests/test_parallel.py).
    """

    qcqp: "QuantizedConstrainedQP"
    mesh: Mesh
    outer: int = 10
    inners: int = 40

    def __post_init__(self):
        tp = self.mesh.shape["tp"]
        if self.qcqp.qqp.padded % (4 * tp):
            raise ValueError(
                f"padded horizon {self.qcqp.qqp.padded} must divide into "
                f"4-lane words across tp={tp}"
            )

    @functools.cached_property
    def tp(self) -> int:
        return self.mesh.shape["tp"]

    @functools.cached_property
    def block(self) -> int:
        return self.qcqp.qqp.padded // self.tp

    @functools.cached_property
    def _lower_word(self) -> np.uint32:
        w = 0
        for off in CONTROL_LAYOUT.offsets:
            w |= (-127 & 0xFF) << off
        return np.uint32(w)

    # -- shard-local program ---------------------------------------------------

    def _c_pre_psum(self, lanes_r: Array, Sq_cols: Array) -> Array:
        """This rank's constraint contribution, psum-reduced to the exact
        full (B_loc, Cp) int32 plane (== ConstrainedPGD._c_pre)."""
        q = self.qcqp
        partial = jax.lax.dot_general(
            lanes_r.astype(jnp.int8),
            Sq_cols,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # (B_loc, Cp)
        acc = jax.lax.psum(partial, "tp")
        return (acc * np.int32(q.cs_num)) >> np.int32(q.cs_den)

    def _local_solve(
        self,
        u_words: Array,
        g_pre: Array,
        c_off: Array,
        lam0: Array,
        Hq: Array,
        Sq: Array,
    ):
        """ALM loop on this rank's (B_loc, block) column block.

        u_words (B_loc, block/4) uint32; g_pre (B_loc, block) int32;
        c_off / lam0 (B_loc, Cp) int32 tp-replicated; Hq (Tp, Tp) int8;
        Sq (Cp, Tp) int8.  Same iteration constants as ConstrainedPGD.
        solve_words -- keep the two in lockstep (bit-identity is tested).
        """
        from pint_jax.mpc.constrained import _LAM_CAP, _Y_BITS

        q = self.qcqp
        qq = q.qqp
        r = jax.lax.axis_index("tp")
        Hq_cols = jax.lax.dynamic_slice_in_dim(
            Hq, r * self.block, self.block, axis=1
        )  # (Tp, block)
        Sq_cols = jax.lax.dynamic_slice_in_dim(
            Sq, r * self.block, self.block, axis=1
        )  # (Cp, block)
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
            lanes = unpack_controls(words)  # (B_loc, block)
            partial = jax.lax.dot_general(
                lanes.astype(jnp.int8),
                Hq_cols,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (B_loc, Tp)
            acc = jax.lax.psum(partial, "tp")
            acc_blk = jax.lax.dynamic_slice_in_dim(
                acc, r * self.block, self.block, axis=1
            )
            pre = (acc_blk * np.int32(qq.hs_num)) >> np.int32(qq.hs_den)
            t = self._c_pre_psum(lanes, Sq_cols) + c_off + lam
            y = t - jnp.clip(t, lo, hi) + ey
            y14 = jnp.clip(
                (y + y_half) >> np.int32(q.y_shift), -y_cap, y_cap
            )
            ey = y - (y14 << np.int32(q.y_shift))
            y_hi = y14 >> np.int32(7)
            y_lo = y14 - (y_hi << np.int32(7))
            acc_h = jax.lax.dot_general(
                y_hi.astype(jnp.int8), Sq_cols,
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (B_loc, block): our gradient columns, no collective
            acc_l = jax.lax.dot_general(
                y_lo.astype(jnp.int8), Sq_cols,
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
            t = (
                self._c_pre_psum(unpack_controls(words), Sq_cols)
                + c_off
                + lam
            )
            lam = jnp.clip(t - jnp.clip(t, lo, hi), -_LAM_CAP, _LAM_CAP)
            return words, carry, ey, lam

        carry0 = g_pre ^ g_pre
        ey0 = c_off ^ c_off
        words, _, _, lam = jax.lax.fori_loop(
            0, self.outer, outer, (u_words, carry0, ey0, lam0)
        )
        return words, lam

    # -- public API --------------------------------------------------------------

    @functools.cached_property
    def solve_words(self):
        """jitted (u_words (B, Tp/4), g_pre (B, Tp), c_off (B, Cp),
        lam0 (B, Cp)) -> (words, lam_pre): batch dp-sharded, horizon
        tp-sharded, constraint plane tp-replicated."""
        fn = shard_map(
            self._local_solve,
            mesh=self.mesh,
            in_specs=(
                P("dp", "tp"),
                P("dp", "tp"),
                P("dp", None),
                P("dp", None),
                P(None, None),
                P(None, None),
            ),
            out_specs=(P("dp", "tp"), P("dp", None)),
        )
        Hq = jnp.asarray(self.qcqp.qqp.Hq)
        Sq = jnp.asarray(self.qcqp.Sq)
        return jax.jit(lambda u, g, c, lam: fn(u, g, c, lam, Hq, Sq))

    def init_words(self, batch: int) -> Array:
        sharding = NamedSharding(self.mesh, P("dp", "tp"))
        return jax.device_put(
            jnp.zeros((batch, self.qcqp.qqp.padded // 4), jnp.uint32),
            sharding,
        )

    def solve(self, x0_phys: np.ndarray) -> Tuple[Array, Array, Array]:
        """End-to-end sharded solve; returns (words, u_phys (B, T) f32,
        lam_pre)."""
        q = self.qcqp
        x0 = np.atleast_2d(x0_phys)
        row = NamedSharding(self.mesh, P("dp", None))
        g_pre = jax.device_put(
            jnp.asarray(q.qqp.g_lane_fixed(x0)),
            NamedSharding(self.mesh, P("dp", "tp")),
        )
        c_off = jax.device_put(jnp.asarray(q.c_off_pre(x0)), row)
        lam0 = jax.device_put(
            jnp.zeros((x0.shape[0], q.padded_rows), jnp.int32), row
        )
        words, lam = self.solve_words(
            self.init_words(x0.shape[0]), g_pre, c_off, lam0
        )
        lanes = unpack_controls(words)[:, : q.qqp.horizon]
        return (
            words,
            lanes.astype(jnp.float32) * np.float32(q.qqp.u_scale),
            lam,
        )
