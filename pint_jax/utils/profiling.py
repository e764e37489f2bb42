"""Profiling and roofline reporting.

The reference's profiling story is its Google-Benchmark comparison matrix
(pint_bench.cpp; SURVEY.md section 5).  On the device, the equivalents are:

* :func:`trace` -- context manager around `jax.profiler` producing a
  TensorBoard-loadable trace of the jitted programs (op fusion, HBM traffic,
  per-op wall time).
* :func:`roofline_report` -- given measured op rates from bench.py, compute
  arithmetic intensity and the memory/ALU bound for each packed op, reporting
  efficiency vs speed-of-light.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import jax

from pint_jax.layout import PackedLayout

__all__ = ["trace", "roofline_report", "op_word_costs"]


@contextlib.contextmanager
def trace(logdir: str = "/tmp/pint_jax_trace") -> Iterator[None]:
    """Profile the enclosed block with the JAX/XLA profiler."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# Whole-word int32 ALU op counts per packed op (AND/OR/XOR/ADD/SUB/SHIFT all count
# 1), derived from the branch-free formulas in pint_jax.ops.word.  ``d`` is
# the number of saturation-dispatch terms of the layout.
def op_word_costs(layout: PackedLayout) -> Dict[str, int]:
    d = len(layout.sat_terms) * 2 + (
        1 if layout.sat_final_mask is not None else 0
    )
    smear = 2 + d            # shift, sub, dispatch
    carry = 5                # (a&b)|((a|b)&~(a+b))
    return {
        "add_wrap": 6,
        "sub_wrap": 10,
        "add_unsigned_saturate": 6 + carry + 1 + smear + 1,
        "sub_unsigned_saturate": 7 + carry + 1 + smear + 1 + 6,
        "add_signed_saturate": 6 + 4 + 2 * (1 + d) + 4,
        "sub_signed_saturate": 10 + 5 + 2 * (1 + d) + 4,
        "min_unsigned": carry + 1 + smear + 3,
        "max_unsigned": carry + 1 + smear + 3,
        "min_signed": carry + 3 + smear + 3,
        "max_signed": carry + 3 + smear + 3,
        # per-word work after the (scalar) mask build: and, shift, guard-and
        "shift_left": 3,
        "shift_right_unsigned": 3,
    }


# words of memory traffic per op application (binops stream 2 in + 1 out;
# shifts stream 1 in + 1 out -- the amount is a scalar)
_TRAFFIC_WORDS = {"shift_left": 2, "shift_right_unsigned": 2}


def roofline_report(
    layout: PackedLayout,
    measured_words_per_s: Dict[str, float],
    mem_bytes_per_s: float,
    alu_ops_per_s: float,
) -> Dict[str, Dict[str, float]]:
    """Efficiency of each measured op vs its memory/ALU roofline.

    An elementwise binop streams 3 words (2 in, 1 out; shifts 2); the
    bound is min(memory words/s, ALU words/s given the op's whole-word op
    count).  ``mem_bytes_per_s`` must be calibrated in the SAME residency
    regime as the measurements (cache-resident operands for the bench's
    compute table; device-memory streaming otherwise) -- bench.py uses the raw
    uint32-add rate of the identical chained harness, the analog of the
    reference's ``Baseline`` fixture (pint_bench.cpp:77-83).
    """
    costs = op_word_costs(layout)
    out = {}
    for op, wps in measured_words_per_s.items():
        c = costs.get(op)
        words = _TRAFFIC_WORDS.get(op, 3)
        mem_bound = mem_bytes_per_s / (words * layout.word_dtype.itemsize)
        bounds = [mem_bound]
        if c:
            bounds.append(alu_ops_per_s / c)
        sol = min(bounds)
        out[op] = {
            "measured_Gwords_per_s": wps / 1e9,
            "speed_of_light_Gwords_per_s": sol / 1e9,
            "efficiency": wps / sol,
            "bound": "mem" if sol == mem_bound else "alu",
        }
    return out
