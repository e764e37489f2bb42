"""Bench for the packed SWAR ops + MPC solves/s, on the GPU.

Streams word tensors through the jitted ops and the solvers through their
entry points, the analog of the reference's Google-Benchmark suite
(tests/pint_bench.cpp: 100M random uint32 pairs through each op, items/s
against scalar/SSE2/NEON baselines, pint_bench.cpp:24-37, 59-95).

The packed elementwise ops are bound by memory bandwidth (a handful of
int32 ops per word against 12 bytes of traffic).  The calibration -- raw
uint32 add, the analog of the reference's ``Baseline`` fixture
(pint_bench.cpp:77-83) -- measures achievable words/s for the same traffic
pattern; ``vs_baseline`` of the headline is measured lane rate over
``lanes_per_word x raw_words_per_s``.

Timing: every sample chains ``inner`` executions through a data
dependency inside one ``fori_loop`` program and takes the host clock
around ``block_until_ready`` (pint_jax/utils/timing.py).

The run needs a GPU: without one it exits non-zero before measuring.  A
section that fails is recorded in the results and the process exits
non-zero.  Outputs ONE JSON line on stdout; progress goes to stderr; the
full results go to chiprun_out/bench_<mode>.json.

Modes:

* default: headline ratio + MPC solves/s headliners, reps=3, wall-clock
  budget ``BENCH_BUDGET_S`` (default 2100s) with per-section skip gates.
* ``--full``: no budget gates, reps=5, plus the per-op two-regime table,
  roofline and pack/unpack.
* ``--sqp``: adds DeviceSQP phase attribution to either mode.
* ``--sweep``: width sweep + int32 op rate + u64 family.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from pint_jax import PackedLayout
from pint_jax.ops import word as W
from pint_jax.utils.compile_cache import enable_compile_cache
from pint_jax.utils.timing import time_chained

N_WORDS = 1 << 24  # 16Mi words, 64 MiB per operand
INNER = 1024       # chained executions per sample
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")

# per-metric run-to-run spread: label -> {rate_min, rate_med, rate_max,
# reps}.  Written into the results' "spread" section so every
# headline number carries its measured variance (no prose ranges).
SPREADS: dict = {}

# wall-clock budget guard: optional sections are skipped when the
# remaining budget is thin, and progress goes to stderr so a killed run
# still shows where it died.
_T0 = time.time()
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "2100"))


def _elapsed() -> float:
    return time.time() - _T0


def _left() -> float:
    return _BUDGET_S - _elapsed()


def note(msg: str) -> None:
    """Progress line on stderr (stdout carries only the one JSON line)."""
    print(f"[bench {_elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)


class _SpreadInto(list):
    """stats_out sink for time_chained that records the per-sample spread
    straight into SPREADS under a fixed label (seconds, not rates)."""

    def __init__(self, label):
        super().__init__()
        self.label = label

    def append(self, v):
        super().append(v)
        lo, med, hi = v
        SPREADS[self.label] = {
            "sec_min": lo, "sec_med": med, "sec_max": hi,
        }


def _spread(label):
    return _SpreadInto(label)


def _timed_rate(label, numerator, step, x0, *consts, inner, reps=5):
    """Median rate = numerator/sec over ``reps`` samples; records spread."""
    note(f"{label}: compiling + timing (inner={inner}, reps={reps})")
    t0 = time.time()
    st: list = []
    sec = time_chained(
        step, x0, *consts, inner=inner, reps=reps,
        stats_out=st,
    )
    note(f"{label}: done in {time.time() - t0:.1f}s "
         f"-> {numerator / sec:.4g}/s")
    lo, med, hi = st[0]
    SPREADS[label] = {
        "rate_min": numerator / hi,
        "rate_med": numerator / med,
        "rate_max": numerator / lo,
        "reps": reps,
    }
    return numerator / sec


def _rand_words(layout: PackedLayout, n: int, seed: int):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << layout.word_bits, size=n, dtype=np.uint64)
    return jnp.asarray((w & np.uint64(layout.used_mask)).astype(layout.word_dtype))


def bench_raw_add(n: int, tag: str = "",
                  inner: int = INNER) -> float:
    """Calibration: raw uint32 elementwise add, words/s."""
    a = jnp.arange(n, dtype=jnp.uint32)
    b = a | jnp.uint32(1)
    return _timed_rate(
        f"raw_u32_add{tag}", n, lambda x, y: x + y, a, b,
        inner=inner,
    )


def bench_packed_op(layout, opname, n, inner=None, tag=""):
    """(words/s, lane ops/s) of a jitted packed op (binop or shift).

    With the default 64MiB operands every step streams both operands
    from device memory; at n <= 2Mi words they fit the 50 MB L2 and the
    rate approaches compute (use ``tag='_l2'`` + a large ``inner`` for
    that regime).
    """
    a = _rand_words(layout, n, 0)
    label = f"{opname}_{'x'.join(map(str, layout.widths))}{tag}"
    formula = getattr(W, opname)
    if opname in ("shift_left", "shift_right_unsigned"):
        # shifts are 2-traffic-word ops and very fast: a longer chain
        amount = jnp.uint32(min(3, layout.max_width - 1))
        wps = _timed_rate(
            label, n, lambda x: formula(layout, x, amount), a,
            inner=4 * (inner or INNER),
        )
    else:
        b = _rand_words(layout, n, 1)
        wps = _timed_rate(
            label, n, lambda x, y: formula(layout, x, y), a, b,
            inner=inner or INNER,
        )
    return wps, wps * layout.num_lanes


def bench_stream_pingpong(layout, opname, n):
    """HBM-streaming words/s with BOTH operands loop-varying.

    The single-carry chain lets XLA hoist loop-invariant subexpressions of
    the fixed operand (e.g. ``~b`` in sub_wrap) into full-size buffers, so
    op rates can depend on formula shape, not cost.  Ping-ponging
    ``(x, y) -> (y, op(x, y))`` defeats the hoist.
    """
    a = _rand_words(layout, n, 0)
    b = _rand_words(layout, n, 1)
    formula = getattr(W, opname)

    def step(c):
        x, y = c
        return (y, formula(layout, x, y))

    wps = _timed_rate(
        f"{opname}_{'x'.join(map(str, layout.widths))}_stream", n,
        step, (a, b), inner=INNER,
    )
    return wps, wps * layout.num_lanes


def bench_pack_unpack(layout, n):
    """words/s for an unpack->pack roundtrip."""
    v = _rand_words(layout, n, 2)
    return _timed_rate(
        "pack_unpack_roundtrip", n,
        lambda x: W.pack(layout, W.unpack(layout, x)), v,
        inner=16 * INNER,
    )


def bench_mpc(batch=8192, horizon=50, iters=40, reps=5):
    """Quantized MPC solves/s, single card (BASELINE.json headline #2).

    Returns (word-space, fused kernel, fused momentum) solves/s; the
    kernel runs the 40-iteration loop in one launch and is verified
    bit-identical before timing.
    """
    from pint_jax.mpc import (
        FixedPointPGD,
        FusedPGD,
        condense_double_integrator,
        quantize,
    )

    qp = condense_double_integrator(T=horizon)
    qqp = quantize(qp)
    solver = FixedPointPGD(qqp, iters=iters)
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-3, 3, batch), rng.uniform(-1, 1, batch)], axis=-1
    )
    g = jnp.asarray(qqp.g_lane_fixed(x0))
    u0 = solver.init_words(batch)
    rate_word = _timed_rate(
        "mpc_word_space", batch, solver.solve_words, u0, g,
        inner=256, reps=reps,
    )

    fused = FusedPGD(qqp, iters=iters)
    w1 = jax.jit(solver.solve_words)(u0, g)
    w2 = fused.solve_words(u0, g)
    assert bool(jnp.all(w1 == w2)), "fused solver diverged from reference"
    rate_fused = _timed_rate(
        "mpc_fused", batch, fused.solve_words, u0, g,
        inner=1024, reps=reps,
    )

    # equal-accuracy accelerated config: Nesterov momentum reaches the
    # 40-iter PGD cost in ~20 iterations (tests/test_accelerated.py)
    accel = FusedPGD(qqp, iters=20, momentum=True)
    from pint_jax.mpc.accelerated import AcceleratedPGD

    w3 = accel.solve_words(u0, g)
    w3_ref = jax.jit(AcceleratedPGD(qqp, iters=20).solve_words)(u0, g)
    assert bool(jnp.all(w3 == w3_ref)), "fused momentum diverged"
    rate_accel = _timed_rate(
        "mpc_fused_momentum", batch, accel.solve_words, u0, g,
        inner=1024, reps=reps,
    )
    return rate_word, rate_fused, rate_accel


def bench_device_sqp(batch=4096, reps=5, inner=32):
    """On-device nonlinear SQP solves/s: the full linearize/condense/
    quantize/PGD loop as one XLA program (mpc.device_sqp.DeviceSQP),
    unicycle goal-reaching, T=32, 4 SQP x 30 PGD iterations."""
    from pint_jax.mpc import DeviceSQP

    dev = DeviceSQP(
        horizon=32, sqp_iters=4, pgd_iters=30,
        Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
        qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
    )
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(-0.2, 0.2, batch),
            rng.uniform(0, 1, batch),
        ],
        axis=-1,
    ).astype(np.float32)
    x0j = jnp.asarray(x0)
    u0 = dev.init_words(batch)
    return _timed_rate(
        "device_sqp", batch, lambda w, x: dev._solve_jit(w, x), u0, x0j,
        inner=inner, reps=reps,
    )


def bench_device_sqp_phases(batch=4096):
    """Phase attribution for the on-device SQP (the DeviceSQP roofline):
    times the full solve and each phase as its own chained program --
    rollout+linearize, condense+quantize (includes rollout), and the
    fixed-point PGD inner -- so the binding phase is measured, not guessed.
    Returns a dict of seconds-per-batch numbers plus derived shares."""
    from pint_jax.mpc import DeviceSQP
    from pint_jax.mpc.ltv import _pgd_batched_h

    dev = DeviceSQP(
        horizon=32, sqp_iters=4, pgd_iters=30,
        Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
        qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
        # phases attribute the XLA inner; the kernel-inner numbers follow
        # in the sqp_phase_full_kernel / sqp_phase_pgd_fused rows below
        fused=False,
    )
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.2, 0.2, batch),
         rng.uniform(0, 1, batch)], axis=-1,
    ).astype(np.float32)
    x0j = jnp.asarray(x0)
    u0 = dev.init_words(batch)
    T, m, Tm = dev.horizon, dev.n_ctrl, dev.n_dec
    s = jnp.asarray(dev._lane_scales, jnp.float32)
    lanes0 = jnp.asarray(
        rng.integers(-100, 100, (batch, Tm), dtype=np.int32)
    )

    out = {"batch": batch, "T": T, "sqp_iters": dev.sqp_iters,
           "pgd_iters": dev.pgd_iters}

    # full solve (4 SQP outers)
    full = _timed_rate(
        "sqp_phase_full", batch,
        lambda w, x: dev._solve_jit(w, x), u0, x0j,
        inner=32, reps=5,
    )
    out["full_s_per_batch"] = batch / full

    # rollout + linearize only (per SQP outer)
    def roll_lin(x, lanes):
        u_phys = lanes.reshape(-1, T, m).astype(jnp.float32) * s
        traj = dev.model.rollout_f32(x, u_phys)
        A_seq, B_seq = dev.model.linearize_f32(traj[:, :-1], u_phys)
        return x + jnp.mean(A_seq) * jnp.float32(1e-20) + jnp.mean(
            B_seq
        ) * jnp.float32(1e-20) + traj[:, -1] * jnp.float32(1e-20)

    # the rollout+linearize step is tiny next to condensation: a long
    # chain keeps the sample well above timer resolution
    rl = _timed_rate(
        "sqp_phase_rollout_linearize", batch, roll_lin, x0j, lanes0,
        inner=4096, reps=5,
    )
    out["rollout_linearize_s_per_outer"] = batch / rl

    # condense + quantize (includes one rollout+linearize; per SQP outer)
    def cond(x, lanes):
        Hq, g_pre, hs_num, hs_den = dev._condense_dev(x, lanes)
        return x + g_pre[:, :3].astype(jnp.float32) * jnp.float32(1e-20) + (
            Hq[:, 0, :3].astype(jnp.float32) * jnp.float32(1e-20)
        )

    cd = _timed_rate(
        "sqp_phase_condense", batch, cond, x0j, lanes0,
        inner=64, reps=5,
    )
    out["condense_s_per_outer"] = batch / cd
    out["propagate_mode"] = dev.propagate

    # H/g assembly alone (condense minus Lipschitz + quantize)
    def cond_hg(x, lanes):
        H, g = dev._condense_hg(x, lanes)
        return x + g[:, :3] * jnp.float32(1e-20) + (
            H[:, 0, :3] * jnp.float32(1e-20)
        )

    hg = _timed_rate(
        "sqp_phase_condense_hg", batch, cond_hg, x0j, lanes0,
        inner=64, reps=5,
    )
    out["condense_hg_s_per_outer"] = batch / hg

    # power-iteration Lipschitz alone, on a real condensed Hessian in the
    # solver's internal batch-last (Tm,Tm,B) layout
    H_real, _ = jax.jit(dev._condense_ht)(x0j, lanes0)

    def lipschitz(H):
        return H + dev._lipschitz_phase(H)[None, None, :] * jnp.float32(
            1e-20
        )

    lp = _timed_rate(
        "sqp_phase_lipschitz", H_real.shape[-1], lipschitz, H_real,
        inner=64, reps=5,
    )
    out["lipschitz_s_per_outer"] = batch / lp

    # PGD inner loop alone (30 iterations; per SQP outer), with operands
    # from one real condensation
    Hq, g_pre, hs_num, hs_den = jax.jit(dev._condense_dev)(x0j, lanes0)
    pg = _timed_rate(
        "sqp_phase_pgd", batch,
        lambda w: _pgd_batched_h(
            w, g_pre, Hq, hs_num, hs_den,
            iters=dev.pgd_iters, g_shift=dev.g_shift,
        ),
        u0, inner=64, reps=5,
    )
    out["pgd_s_per_outer"] = batch / pg

    # -- the kernel inner (DeviceSQP(fused=True)) ---------------------------
    import dataclasses

    from pint_jax.mpc.fused import pgd_fused_words

    dev_k = dataclasses.replace(dev, fused=True)
    fl = _timed_rate(
        "sqp_phase_full_kernel", batch,
        lambda w, x: dev_k._solve_jit(w, x), u0, x0j,
        inner=32, reps=5,
    )
    out["full_kernel_s_per_batch"] = batch / fl

    fp = _timed_rate(
        "sqp_phase_pgd_fused", batch,
        lambda w: pgd_fused_words(
            w, g_pre, Hq, hs_num, hs_den,
            iters=dev.pgd_iters, g_shift=dev.g_shift,
            block=dev.fused_block,
        ),
        u0, inner=64, reps=5,
    )
    out["pgd_fused_s_per_outer"] = batch / fp

    # derived attribution
    per_outer = out["full_s_per_batch"] / dev.sqp_iters
    out["per_outer_s"] = per_outer
    out["per_outer_kernel_s"] = (
        out["full_kernel_s_per_batch"] / dev.sqp_iters
    )
    out["phase_shares_of_outer"] = {
        "rollout_linearize": out["rollout_linearize_s_per_outer"] / per_outer,
        "hg_assembly_extra": (
            out["condense_hg_s_per_outer"]
            - out["rollout_linearize_s_per_outer"]
        ) / per_outer,
        "lipschitz": out["lipschitz_s_per_outer"] / per_outer,
        "quantize_extra": (
            out["condense_s_per_outer"]
            - out["condense_hg_s_per_outer"]
            - out["lipschitz_s_per_outer"]
        ) / per_outer,
        "pgd": out["pgd_s_per_outer"] / per_outer,
        "unattributed": 1.0 - (
            out["condense_s_per_outer"] + out["pgd_s_per_outer"]
        ) / per_outer,
    }
    return out


def bench_device_constrained_phases(batch=4096):
    """Phase attribution for the device constrained SQP (the
    DeviceConstrainedSQP roofline): full solve, the traced prep
    (linearize/condense/stack/quantize), its stack/pen-Lipschitz
    sub-phases, and the integer ALM inner (3 ALM x 30 PGD) each as their
    own chained program.  Measured round 3: ALM inner 75.6%, prep 16.3%
    (stack 0.4%, pen-Lipschitz 0.9%), unattributed 8.1% of the 32.2 ms
    outer -- the ALM inner is the binding stage (see exp_constrained_
    phases.py for the fused-forward experiment that ruled out matmul
    dispatch count as the bottleneck: +2%)."""
    from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP
    from pint_jax.mpc.sqp_constrained import _alm_batched, _Y_SHIFT

    devc = DeviceConstrainedSQP(
        DeviceSQP(horizon=32, sqp_iters=4, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0])),
        F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3,
    )
    d = devc.dev
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(np.stack(
        [rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.2, 0.2, batch),
         rng.uniform(-np.pi, np.pi, batch)], axis=-1).astype(np.float32))
    u0 = devc.init_words(batch)
    lam0 = devc.init_lam(batch)
    lanes0 = jnp.asarray(
        rng.integers(-100, 100, (batch, d.n_dec), dtype=np.int32))
    out = {"batch": batch, "T": d.horizon, "sqp_iters": d.sqp_iters,
           "alm_outer": devc.alm_outer, "pgd_iters": d.pgd_iters}

    sec = time_chained(
        lambda st, x: devc._solve_jit(st[0], x, st[1]), (u0, lam0), x0,
        inner=16, reps=3)
    out["full_s_per_batch"] = sec
    per_outer = sec / d.sqp_iters
    out["per_outer_s"] = per_outer

    def prep(x, lanes):
        ops, c_unit = devc._condense_constrained_dev(x, lanes)
        acc = c_unit
        for k in ("g_pre", "c_off", "lo_pre"):
            acc = acc + ops[k][:, 0].astype(jnp.float32) * jnp.float32(1e-20)
        acc = acc + ops["Hq"][:, 0, 0].astype(jnp.float32) * jnp.float32(
            1e-20)
        acc = acc + ops["Sq"][:, 0, 0].astype(jnp.float32) * jnp.float32(
            1e-20)
        return x + acc[:, None] * jnp.float32(1e-20)

    out["prep_s_per_outer"] = time_chained(
        prep, x0, lanes0, inner=64, reps=3)

    ops, _ = jax.jit(devc._condense_constrained_dev)(x0, lanes0)
    ORDER = ("g_pre", "Hq", "hs_num", "hs_den", "Sq", "cs_num", "cs_den",
             "c_off", "lo_pre", "hi_pre", "eh_num", "eh_den", "el_num",
             "el_den")

    def alm(st):
        w, lam = st
        return _alm_batched(
            w, *[ops[k] for k in ORDER], lam,
            outer=devc.alm_outer, inners=d.pgd_iters,
            g_shift=d.g_shift, y_shift=_Y_SHIFT)

    out["alm_s_per_outer"] = time_chained(
        alm, (u0, lam0), inner=64, reps=3)
    out["phase_shares_of_outer"] = {
        "prep": out["prep_s_per_outer"] / per_outer,
        "alm": out["alm_s_per_outer"] / per_outer,
        "unattributed": 1.0 - (out["prep_s_per_outer"]
                               + out["alm_s_per_outer"]) / per_outer,
    }
    return out


def bench_device_constrained(batch=4096, reps=5, inner=16):
    """Device-resident state-constrained nonlinear SQP solves/s: rollout/
    linearize/condense/stack/quantize + integer ALM inners as ONE XLA
    program (mpc.device_constrained.DeviceConstrainedSQP), corridor-bounded
    unicycle, T=32, 4 SQP x (3 ALM x 30 PGD) iterations."""
    from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP

    devc = DeviceConstrainedSQP(
        DeviceSQP(horizon=32, sqp_iters=4, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0])),
        F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3,
    )
    rng = np.random.default_rng(0)
    x0 = jnp.asarray(
        np.stack(
            [rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.2, 0.2, batch),
             rng.uniform(-np.pi, np.pi, batch)], axis=-1,
        ).astype(np.float32)
    )
    u0 = devc.init_words(batch)
    lam0 = devc.init_lam(batch)
    return _timed_rate(
        "device_constrained_sqp", batch,
        lambda st, x: devc._solve_jit(st[0], x, st[1]),
        (u0, lam0), x0, inner=inner, reps=reps,
    )


def bench_constrained(batch=4096, horizon=50, reps=5):
    """State-constrained ALM solves/s: velocity-limited double integrator,
    12 outer multiplier updates x 60 error-feedback PGD inners as one
    integer XLA program (mpc.constrained.ConstrainedPGD)."""
    from pint_jax.mpc import (
        ConstrainedPGD,
        condense_double_integrator,
        constrain_states,
        quantize_constrained,
    )

    dt = 1.0 / 32.0
    qp = condense_double_integrator(T=horizon, dt=dt, q_pos=4.0)
    A = np.array([[1.0, dt], [0.0, 1.0]])
    Bm = np.array([[0.5 * dt * dt], [dt]])
    sc = constrain_states(
        qp,
        np.broadcast_to(A, (horizon, 2, 2)),
        np.broadcast_to(Bm, (horizon, 2, 1)),
        None,
        F=[[0.0, 1.0]],
        lo=-0.25,
        hi=0.25,
    )
    solver = ConstrainedPGD(quantize_constrained(sc, rho=50.0), outer=12, inners=60)
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-1.5, 1.5, batch), rng.uniform(-0.2, 0.2, batch)],
        axis=-1,
    )
    g = jnp.asarray(solver._q.g_lane_fixed(x0))
    co = jnp.asarray(solver.qcqp.c_off_pre(x0))
    fn = jax.jit(lambda w: solver.solve_words(w, g, co)[0])
    return _timed_rate(
        "mpc_constrained", batch, fn, solver.init_words(batch),
        inner=32, reps=reps,
    )


def bench_serving(reps=30, b_lti=8192, b_rti=4096) -> dict:
    """Serving-loop latency (VERDICT round-3 Missing #3): tick timing for
    the three production endpoints.

    Two regimes per endpoint:
    * device tick rate -- the warm-state update chained on device via
      ``time_chained`` (what a pipelined deployment sustains),
    * end-to-end ``.solve()`` latency percentiles -- one numpy-in /
      numpy-out tick including the device->host fetch.
    """
    from pint_jax.mpc import (
        DeviceConstrainedSQP,
        DeviceSQP,
        condense_double_integrator,
        quantize,
    )
    from pint_jax.serving import (
        ConstrainedRTIService,
        MPCService,
        RTIService,
    )

    out = {}
    rng = np.random.default_rng(0)

    def e2e(svc, x0, n=reps):
        svc.solve(x0)                       # warm/compile
        lat = []
        for _ in range(n):
            t0 = time.perf_counter()
            svc.solve(x0)
            lat.append(time.perf_counter() - t0)
        lat = np.asarray(lat)
        return (float(np.percentile(lat, 50) * 1e3),
                float(np.percentile(lat, 99) * 1e3))

    # -- MPCService: LTI quantized MPC, batch 8192, T=50 ---------------------
    b = b_lti
    qqp = quantize(condense_double_integrator(T=50))
    svc = MPCService(qqp, batch=b, iters_per_tick=15)
    x0 = np.stack([rng.uniform(-3, 3, b), rng.uniform(-1, 1, b)], axis=-1)
    g = jnp.asarray(qqp.g_lane_fixed(x0))
    # the LTI tick is tens of us: a 2048-tick chain per sample
    sec = time_chained(
        lambda w, gg: svc._tick(w, gg)[1], svc._solver.init_words(b), g,
        inner=2048, reps=5,
        stats_out=_spread("serving_mpc"),
    )
    out["mpc_tick_device_us"] = sec * 1e6
    out["mpc_ticks_per_s_device"] = 1.0 / sec
    p50, p99 = e2e(svc, x0)
    out["mpc_solve_p50_ms"], out["mpc_solve_p99_ms"] = p50, p99
    # the float64 host linear-term path for comparison (a per-tick host
    # cost that grows with the batch -- the reason g_on_device is the
    # default)
    svc_h = MPCService(qqp, batch=b, iters_per_tick=15, g_on_device=False)
    p50h, p99h = e2e(svc_h, x0, n=max(5, reps // 3))
    out["mpc_solve_hostg_p50_ms"] = p50h
    out["mpc_solve_hostg_p99_ms"] = p99h

    # -- RTIService: nonlinear RTI (DeviceSQP, 1 SQP/tick), batch 4096 -------
    b = b_rti
    sqp = DeviceSQP(horizon=32, sqp_iters=1, pgd_iters=30,
                    Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
                    qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]))
    rti = RTIService(sqp, batch=b)
    x0r = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                    rng.uniform(0, 1, b)], axis=-1)
    x0rj = jnp.asarray(x0r, jnp.float32)
    sec = time_chained(
        lambda w, x: rti._tick(w, x)[0], rti._zero, x0rj,
        inner=16, reps=5, stats_out=_spread("serving_rti"),
    )
    out["rti_tick_device_us"] = sec * 1e6
    out["rti_ticks_per_s_device"] = 1.0 / sec
    p50, p99 = e2e(rti, x0r)
    out["rti_solve_p50_ms"], out["rti_solve_p99_ms"] = p50, p99

    # -- ConstrainedRTIService: constrained RTI, batch 4096 ------------------
    csqp = DeviceConstrainedSQP(
        DeviceSQP(horizon=32, sqp_iters=1, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0])),
        F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3,
    )
    crti = ConstrainedRTIService(csqp, batch=b)
    x0c = np.stack([rng.uniform(-0.2, 0.2, b), rng.uniform(-0.2, 0.2, b),
                    rng.uniform(-np.pi, np.pi, b)], axis=-1)
    x0cj = jnp.asarray(x0c, jnp.float32)
    sec = time_chained(
        lambda st, x: crti._tick(st[0], st[1], x)[:2],
        (crti._zero, crti._zero_lam), x0cj,
        inner=8, reps=5, stats_out=_spread("serving_crti"),
    )
    out["crti_tick_device_us"] = sec * 1e6
    out["crti_ticks_per_s_device"] = 1.0 / sec
    p50, p99 = e2e(crti, x0c)
    out["crti_solve_p50_ms"], out["crti_solve_p99_ms"] = p50, p99
    return out


def bench_device_t50(batch=4096, reps=5) -> dict:
    """Device-tier solvers at the BASELINE.json north-star horizon T=50
    (VERDICT round-3 item 7): the headline configs re-measured at the
    mandated horizon for both DeviceSQP and DeviceConstrainedSQP."""
    from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP

    out = {}
    rng = np.random.default_rng(0)
    dev = DeviceSQP(
        horizon=50, sqp_iters=4, pgd_iters=30,
        Q=np.diag([1.0, 1.0, 0.005]), R=np.diag([0.005, 0.005]),
        qf_scale=60.0, x_ref=np.array([0.2, 0.1, 0.0]),
    )
    x0 = jnp.asarray(np.stack(
        [rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.2, 0.2, batch),
         rng.uniform(0, 1, batch)], axis=-1).astype(np.float32))
    out["device_sqp_T50_solves_per_s"] = _timed_rate(
        "device_sqp_T50", batch, lambda w, x: dev._solve_jit(w, x),
        dev.init_words(batch), x0, inner=8, reps=reps,
    )

    devc = DeviceConstrainedSQP(
        DeviceSQP(horizon=50, sqp_iters=4, pgd_iters=30,
                  x_ref=np.array([1.0, 0.0, 0.0])),
        F=[[0.0, 1.0, 0.0]], lo=-0.03, hi=0.03, rho=100.0, alm_outer=3,
    )
    x0c = jnp.asarray(np.stack(
        [rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.2, 0.2, batch),
         rng.uniform(-np.pi, np.pi, batch)], axis=-1).astype(np.float32))
    out["device_constrained_T50_solves_per_s"] = _timed_rate(
        "device_constrained_T50", batch,
        lambda st, x: devc._solve_jit(st[0], x, st[1]),
        (devc.init_words(batch), devc.init_lam(batch)), x0c,
        inner=4, reps=reps,
    )
    return out


def bench_quadrotor_device(batch=4096, reps=5) -> dict:
    """Third-model-family device-tier rows (VERDICT round-4 item 6): the
    PlanarQuadrotor (n=6 states, m=2 coupled inputs) through DeviceSQP
    and DeviceConstrainedSQP -- the biggest state/multi-input geometry in
    the zoo (Tm = 2T lanes, 6x6 condensation blocks)."""
    from pint_jax.models.quadrotor import PlanarQuadrotor
    from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP

    out = {}
    rng = np.random.default_rng(0)
    kw = dict(
        model=PlanarQuadrotor(), horizon=16, sqp_iters=4, pgd_iters=30,
        Q=np.diag([4.0, 4.0, 1.0, 0.2, 0.2, 0.1]),
        R=np.diag([0.05, 0.05]), qf_scale=20.0, x_ref=np.zeros(6),
    )
    dev = DeviceSQP(**kw)
    x0 = jnp.asarray(np.stack(
        [rng.uniform(-0.3, 0.3, batch), rng.uniform(-0.3, 0.3, batch),
         rng.uniform(-0.03, 0.03, batch), rng.uniform(-0.2, 0.2, batch),
         rng.uniform(-0.2, 0.2, batch), rng.uniform(-0.05, 0.05, batch)],
        axis=-1).astype(np.float32))
    out["quadrotor_device_sqp_T16_solves_per_s"] = _timed_rate(
        "quadrotor_device_sqp_T16", batch,
        lambda w, x: dev._solve_jit(w, x),
        dev.init_words(batch), x0, inner=16, reps=reps,
    )
    devc = DeviceConstrainedSQP(
        DeviceSQP(**kw),
        F=[[0.0, 0.0, 0.0, 0.0, 1.0, 0.0]], lo=-0.15, hi=0.15,
        rho=50.0, alm_outer=3,
    )
    out["quadrotor_device_constrained_T16_solves_per_s"] = _timed_rate(
        "quadrotor_device_constrained_T16", batch,
        lambda st, x: devc._solve_jit(st[0], x, st[1]),
        (devc.init_words(batch), devc.init_lam(batch)), x0,
        inner=8, reps=reps,
    )
    return out


def bench_int32_ops(n: int = 1 << 18, ops_per_pass: int = 64,
                  lanes: int = 4) -> float:
    """Sustained int32 whole-word ops/s: ``lanes`` INDEPENDENT fused
    chains of shift/xor/add on small (cache-resident) arrays, so memory
    traffic per op is negligible.  Feeds roofline_report's alu_ops_per_s.

    A single dependent chain measures issue latency and understates the
    bound -- the word formulas have parallel subexpressions.  Four
    interleaved chains expose the instruction-level parallelism a real
    formula body has.
    """
    xs0 = tuple(
        jnp.arange(n, dtype=jnp.uint32) + jnp.uint32(i) for i in range(lanes)
    )
    c1 = jnp.uint32(0x9E3779B9)

    def step(xs):
        xs = list(xs)
        for _ in range(ops_per_pass // 4):
            for i in range(lanes):
                xs[i] = xs[i] ^ (xs[i] << jnp.uint32(1))
            for i in range(lanes):
                xs[i] = xs[i] + c1
            for i in range(lanes):
                xs[i] = xs[i] ^ (xs[i] >> jnp.uint32(3))
            for i in range(lanes):
                xs[i] = xs[i] | jnp.uint32(1)
        return tuple(xs)

    return _timed_rate(
        "int32_ops", n * lanes * ops_per_pass, step, xs0,
        inner=16384,
    )


def bench_width_sweep() -> dict:
    """Saturating-add lane throughput over a lane-width sweep
    (BASELINE.json config: "pack/unpack + saturating-add throughput sweep
    over lane widths")."""
    out = {}
    sweep = [
        PackedLayout(*([w] * (32 // w))) for w in (1, 2, 4, 8, 16)
    ] + [
        PackedLayout(1, 2, 3, 4, 5, 6, 11),
        PackedLayout(1, 3, 5, 11),          # pint_bench AddSatU1 config
        PackedLayout(11, 11, 10),
    ]
    for lay in sweep:
        wps, lps = bench_packed_op(
            lay, "add_unsigned_saturate", N_WORDS, overhead
        )
        out[f"addsat_u_{'x'.join(map(str, lay.widths))}"] = {
            "Gwords_per_s": wps / 1e9,
            "Glanes_per_s": lps / 1e9,
        }
    return out


def bench_u64_family(n: int = N_WORDS // 2) -> dict:
    """u64 word throughput, three ways (the reference's uint64 8x8 config,
    pint_bench.cpp:468-485):

    * ``xla_emulated``: uint64 arrays through the word.py formulas (XLA
      expands each 64-bit op into 32-bit pairs internally; needs x64),
    * ``xla_split``: the SplitWord half-pair evaluation of the same
      formulas, jitted as plain XLA on u32 arrays (no x64 anywhere),
    * ``pair_entry``: the same through the public pair-word entry
      (``elementwise.binop_pair``).

    Returns G lane-ops/s for add_unsigned_saturate on <8 x 8x8>.
    x64 is flipped on only inside the emulated measurement and restored.
    """
    from pint_jax.ops import elementwise as E
    from pint_jax.ops import split64 as S

    lay = PackedLayout(*([8] * 8))
    rng = np.random.default_rng(7)
    lo = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    hi = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    ap = jnp.asarray(np.stack([lo, hi], axis=0))      # planar (2, n)
    bp = jnp.asarray(np.stack([hi ^ lo, lo | np.uint32(1)], axis=0))
    out = {}
    view = S.SplitView(lay)

    def xla_split(x, y):
        r = W.add_unsigned_saturate(
            view,
            S.SplitWord(x[0], x[1]),
            S.SplitWord(y[0], y[1]),
        )
        return jnp.stack([r.lo, r.hi], axis=0)

    sec = time_chained(xla_split, ap, bp, inner=INNER)
    out["addsat_u8x8_u64_xla_split_Glanes_per_s"] = n * 8 / sec / 1e9

    pair_fn = E.binop_pair(lay, "add_unsigned_saturate")
    sec = time_chained(pair_fn, ap, bp, inner=INNER)
    out["addsat_u8x8_u64_pair_entry_Glanes_per_s"] = n * 8 / sec / 1e9

    try:
        jax.config.update("jax_enable_x64", True)
        a64 = jnp.asarray(
            lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
        )
        b64 = jnp.asarray(
            (hi ^ lo).astype(np.uint64)
            | ((lo | np.uint32(1)).astype(np.uint64) << np.uint64(32))
        )
        sec = time_chained(
            lambda x, y: W.add_unsigned_saturate(lay, x, y),
            a64, b64, inner=INNER,
        )
        out["addsat_u8x8_u64_xla_emulated_Glanes_per_s"] = n * 8 / sec / 1e9
    finally:
        jax.config.update("jax_enable_x64", False)
    return out


def bench_unpacked_comparator(n_items: int):
    """The reference-bench-style comparator: per-field processing without
    SWAR (the array analog of the 'bitfield union + clamp' baselines,
    pint_bench.cpp:117-151, 274-369).

    The 7 heterogeneous fields <1,2,3,4,5,6,11> are held as an (N, 8) int8
    tensor (one byte per field, padded to 8 -- the narrowest native dtype
    that fits each field); saturating add is the naive widen-add-clip-
    narrow.  Returns lane-ops/s.  SWAR packs the same 7 fields in 4 bytes,
    so at equal HBM bandwidth the packed path moves 2x fewer bytes.
    """
    widths = (1, 2, 3, 4, 5, 6, 11, 8)  # 8th char column pads to a lane tile
    maxv = np.array([(1 << w) - 1 for w in widths[:7]] + [127], np.int16)
    rng = np.random.default_rng(3)
    a = jnp.asarray(
        rng.integers(0, 128, size=(n_items, 8), dtype=np.int8)
    )
    b = jnp.asarray(
        rng.integers(0, 128, size=(n_items, 8), dtype=np.int8)
    )
    cap = jnp.asarray(maxv)

    def step(x, y):
        wide = x.astype(jnp.int16) + y.astype(jnp.int16)
        return jnp.minimum(wide, cap).astype(jnp.int8)

    return _timed_rate(
        "unpacked_comparator_het7", n_items * 7, step, a, b,
        inner=INNER,
    )


def bench_rollouts(batch=8192, horizon=52, reps=5):
    """Quantized double-integrator rollouts/s from packed int8 controls
    (BASELINE.json config: 8192 rollouts, H=50; padded to 52 for 4-lane
    words)."""
    from pint_jax.models import DoubleIntegrator, pack_controls

    model = DoubleIntegrator()
    rng = np.random.default_rng(0)
    lanes = jnp.asarray(
        rng.integers(-128, 128, (batch, horizon), dtype=np.int32)
    )
    words = pack_controls(lanes)

    def step(state0, w):
        states = model.rollout_packed(state0, w)
        # depend on the whole trajectory so it cannot be elided
        return states[..., -1, :] + (jnp.sum(states, axis=-2) & 1)

    return _timed_rate(
        "rollouts_di", batch, step,
        jnp.zeros((batch, 2), jnp.int32), words,
        inner=8192, reps=reps,
    )


def _device_stamp() -> dict:
    """Platform, device kind and count as JAX reports them, and the card's
    name and power limit from nvidia-smi (a child process, off JAX)."""
    import subprocess

    d = jax.devices()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card}


def main() -> int:
    import sys

    if jax.devices()[0].platform != "gpu":
        note(f"no GPU (JAX found {jax.devices()[0].platform}); nothing is "
             f"measured")
        return 2
    enable_compile_cache()
    results = {"device": _device_stamp()}
    os.makedirs(OUT_DIR, exist_ok=True)

    if "--sweep" in sys.argv:
        note("mode: --sweep (width sweep + int32 ops + u64 family)")
        results["width_sweep"] = bench_width_sweep()
        results["int32_Tops_per_s"] = bench_int32_ops() / 1e12
        results["u64_family"] = bench_u64_family()

        # unicycle rollouts (fixed-point trig path)
        from pint_jax.models import Unicycle, pack_controls

        uni = Unicycle()
        rng = np.random.default_rng(1)
        batch, horizon = 8192, 50
        ctrl = jnp.asarray(
            rng.integers(-128, 128, (batch, 2 * horizon), dtype=np.int32)
        )
        words = pack_controls(ctrl)

        def uni_step(state0, w):
            states = uni.rollout_packed(state0, w)
            return states[..., -1, :] + (jnp.sum(states, axis=-2) & 1)

        sec = time_chained(
            uni_step,
            jnp.zeros((batch, 3), jnp.int32),
            words,
            inner=1024,
            reps=3,
        )
        results["unicycle_rollouts_per_s_b8192_h50"] = batch / sec
        with open(os.path.join(OUT_DIR, "bench_sweep.json"), "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps({"metric": "width_sweep", "value": 1, "unit": "done",
                          "vs_baseline": 1}))
        return 0

    return run_bench(results, full="--full" in sys.argv,
                     sqp_phases="--sqp" in sys.argv)


def _run_headline(results):
    # headline: the reference's flagship saturating config <8,8,8,8>
    # (pint_bench.cpp:456-467, compared there against SSE2 _mm_adds_epu8).
    # The raw-add calibration brackets the packed measurement (before and
    # after) so clock/thermal drift cancels out of the ratio.
    lay8888 = PackedLayout(8, 8, 8, 8)
    raw_wps_1 = bench_raw_add(N_WORDS, tag="_pre", inner=2 * INNER)
    wps, lps = bench_packed_op(
        lay8888, "add_unsigned_saturate", N_WORDS, inner=2 * INNER
    )
    raw_wps_2 = bench_raw_add(N_WORDS, tag="_post", inner=2 * INNER)
    raw_wps = 0.5 * (raw_wps_1 + raw_wps_2)
    results["baseline_raw_u32_add_Gwords_per_s"] = raw_wps / 1e9
    results["addsat_u8x4_Gwords_per_s"] = wps / 1e9
    results["addsat_u8x4_Glanes_per_s"] = lps / 1e9
    sol_lanes = raw_wps * lay8888.num_lanes
    vs_sol = lps / sol_lanes
    results["addsat_u8x4_vs_speed_of_light"] = vs_sol
    return vs_sol


def _run_full_op_table(results, lay8888, lay_het):
    """The per-op two-regime table + roofline (--full only: ~30
    programs)."""
    # the FULL op surface on both reference configs: the wrap/saturate
    # families of pint_bench.cpp:85-684 plus min/max, sub-saturates and
    # shifts (so the roofline section below covers every public op family).
    #
    # Two regimes, measured separately:
    #  * L2-resident (2Mi words, 8 MiB per operand): per-op compute rate
    #    -> the roofline table vs the ALU / L2 bound.
    #  * HBM-streaming ping-pong (16Mi words, both operands varying):
    #    the memory-bound regime, where every op reaches about the same
    #    rate, so only the four reference bench families are reported.
    all_ops = (
        "add_wrap",
        "sub_wrap",
        "add_unsigned_saturate",
        "sub_unsigned_saturate",
        "add_signed_saturate",
        "sub_signed_saturate",
        "min_unsigned",
        "max_unsigned",
        "min_signed",
        "max_signed",
        "shift_left",
        "shift_right_unsigned",
    )
    N_L2 = 1 << 21
    INNER_L2 = 65536
    raw_l2_wps = bench_raw_add(
        N_L2, tag="_l2", inner=INNER_L2
    )
    results["raw_u32_add_l2_Gwords_per_s"] = raw_l2_wps / 1e9
    measured_wps = {"u8x4": {}, "het7": {}}
    for cfg, lay in (("u8x4", lay8888), ("het7", lay_het)):
        for op in all_ops:
            wps_c, lps_c = bench_packed_op(
                lay, op, N_L2, inner=INNER_L2, tag="_l2"
            )
            measured_wps[cfg][op] = wps_c
            results[f"{op}_{cfg}_l2_Glanes_per_s"] = lps_c / 1e9
    results["addsat_s8x4_l2_Glanes_per_s"] = results[
        "add_signed_saturate_u8x4_l2_Glanes_per_s"
    ]

    # HBM-streaming regime: reference bench families (AddWrap/SubWrap/
    # AddSatU/AddSatS fixtures, pint_bench.cpp:85-151, 224-270, 274-369,
    # 586-632) on both configs
    for cfg, lay in (("u8x4", lay8888), ("het7", lay_het)):
        for op in ("add_wrap", "sub_wrap", "add_unsigned_saturate",
                   "add_signed_saturate"):
            s_wps, s_lps = bench_stream_pingpong(lay, op, N_WORDS)
            results[f"{op}_{cfg}_stream_Glanes_per_s"] = s_lps / 1e9

    # roofline: every op's L2-resident compute rate vs its bound --
    # min(L2 streaming rate for its traffic, ALU rate / whole-word op
    # count).  Memory rate comes from the raw-add calibration in the SAME
    # regime; sustained int32 rate from the fused-chain microbench.
    from pint_jax.utils.profiling import roofline_report

    alu_ops = bench_int32_ops()
    results["int32_Tops_per_s"] = alu_ops / 1e12
    l2_Bps = raw_l2_wps * 12.0
    results["l2_bytes_per_s_from_calibration"] = l2_Bps
    results["roofline"] = {
        cfg: roofline_report(
            lay, measured_wps[cfg], mem_bytes_per_s=l2_Bps,
            alu_ops_per_s=alu_ops,
        )
        for cfg, lay in (("u8x4", lay8888), ("het7", lay_het))
    }

    results["pack_unpack_roundtrip_u8x4_Gwords_per_s"] = (
        bench_pack_unpack(lay8888, N_WORDS // 2) / 1e9
    )


def run_bench(results, full=False, sqp_phases=False):
    """Orchestrate the run under the wall-clock budget.

    Default mode: the headline ratio plus the MPC solves/s headliners,
    reps=3, every optional section gated on remaining budget.  ``--full``
    removes the budget gates, uses reps=5 and adds the per-op two-regime
    table + roofline.  Returns the process exit code: non-zero when any
    section failed.
    """
    lay8888 = PackedLayout(8, 8, 8, 8)
    lay_het = PackedLayout(1, 2, 3, 4, 5, 6, 11)
    reps = 5 if full else 3
    note(f"mode: {'full' if full else 'default'} "
         f"(budget {_BUDGET_S:.0f}s, reps={reps})")

    vs_sol = _run_headline(results)
    note(f"headline done: vs_speed_of_light={vs_sol:.4f}")

    def sec_mpc():
        word_rate, fused_rate, accel_rate = bench_mpc(reps=reps)
        results["mpc_solves_per_s_b8192_h50_i40"] = word_rate
        results["mpc_fused_solves_per_s_b8192_h50_i40"] = fused_rate
        results["mpc_fused_momentum_solves_per_s_b8192_h50_i20"] = accel_rate

    def sec_device_sqp():
        results["mpc_device_sqp_solves_per_s_b4096_T32_i4x30"] = (
            bench_device_sqp(reps=reps, inner=32 if full else 16)
        )

    def sec_constrained():
        results["mpc_constrained_solves_per_s_b4096_T50_i12x60"] = (
            bench_constrained(reps=reps)
        )

    def sec_device_constrained():
        results["mpc_device_constrained_solves_per_s_b4096_T32_i4x3x30"] = (
            bench_device_constrained(reps=reps)
        )

    def sec_rollouts():
        results["rollouts_per_s_b8192_h52"] = bench_rollouts(
            reps=reps
        )

    def sec_comparator():
        # per-field no-SWAR comparator for the hetero config (the
        # reference's bitfield-union baseline, pint_bench.cpp:274-369):
        # same logical lanes, one int8 byte per field.  The packed side is
        # measured in the SAME regime (big-N single-carry chain: fixed
        # operand streamed, carry resident) so the ratio is like-for-like.
        unpacked_lps = bench_unpacked_comparator(N_WORDS)
        results["addsat_u_het7_unpacked_int8_Glanes_per_s"] = (
            unpacked_lps / 1e9
        )
        _, packed_big_lps = bench_packed_op(
            lay_het, "add_unsigned_saturate", N_WORDS, tag="_hbm1"
        )
        results["addsat_u_het7_hbm1_Glanes_per_s"] = packed_big_lps / 1e9
        results["addsat_u_het7_swar_speedup_vs_unpacked"] = (
            packed_big_lps / unpacked_lps
        )

    def sec_op_table():
        _run_full_op_table(results, lay8888, lay_het)

    def sec_serving():
        results["serving"] = bench_serving()

    def sec_device_t50():
        results.update(bench_device_t50(reps=reps))

    def sec_quadrotor():
        results.update(bench_quadrotor_device(reps=reps))

    def sec_sqp_phases():
        results["device_sqp_phases"] = bench_device_sqp_phases()
        results["device_constrained_phases"] = (
            bench_device_constrained_phases()
        )

    # (name, fn, min remaining seconds to even attempt it)
    sections = [
        ("mpc", sec_mpc, 90),
        ("device_sqp", sec_device_sqp, 90),
        ("constrained", sec_constrained, 45),
        ("device_constrained", sec_device_constrained, 60),
        ("rollouts", sec_rollouts, 45),
        ("comparator", sec_comparator, 60),
        ("serving", sec_serving, 120),
    ]
    if full:
        sections.append(("op_table", sec_op_table, 0))
        sections.append(("device_t50", sec_device_t50, 0))
        sections.append(("quadrotor_device", sec_quadrotor, 0))
    if sqp_phases:
        sections.append(("sqp_phases", sec_sqp_phases, 0))

    failed = []
    for name, fn, need in sections:
        if not full and _left() < need:
            note(f"{name}: SKIPPED ({_left():.0f}s left < {need}s needed)")
            results[f"{name}_skipped_budget_s"] = round(_left(), 1)
            continue
        note(f"section {name}: start ({_left():.0f}s budget left)")
        try:
            fn()
        except Exception as e:  # recorded; the exit code reports it
            note(f"section {name}: FAILED {e!r}")
            results[f"{name}_error"] = repr(e)
            failed.append(name)

    results["spread"] = SPREADS
    results["elapsed_s"] = round(_elapsed(), 1)
    out_path = os.path.join(
        OUT_DIR, "bench_full.json" if full else "bench_default.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    note(f"wrote {out_path} ({_elapsed():.0f}s total)")
    if failed:
        note(f"sections failed: {failed}")
        return 1
    print(
        json.dumps(
            {
                "metric": "addsat_u8x4_lane_throughput",
                "value": round(results["addsat_u8x4_Glanes_per_s"], 3),
                "unit": "Glanes/s",
                "vs_baseline": round(vs_sol, 4),
                "device": results["device"],
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
