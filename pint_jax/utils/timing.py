"""Device timing: the host clock around work that ends in
``block_until_ready``.

JAX dispatches asynchronously, so a timing without ``block_until_ready``
measures only the enqueue.  :func:`time_chained` also chains ``inner``
executions of the op under test through a data dependency inside one
jitted ``fori_loop`` program, so the device can neither overlap nor elide
them and the per-launch host cost is paid once per sample.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import jax
import numpy as np

__all__ = ["time_chained"]


def time_chained(
    step: Callable,
    x0,
    *consts,
    reps: int = 5,
    inner: int = 100,
    stats_out: Optional[list] = None,
) -> float:
    """Median seconds per execution of ``step(x, *consts) -> x_next``.

    ``step`` must map its first argument's pytree structure to itself so
    iterations chain through a data dependency.  Each of the ``reps``
    samples times one call of the ``inner``-step chain, after a warm-up
    call that compiles it.

    If ``stats_out`` is given, ``(sec_min, sec_median, sec_max)`` across
    the ``reps`` samples is appended to it, so run-to-run variance is
    visible per metric.
    """

    @jax.jit
    def chain(x, *cs):
        return jax.lax.fori_loop(0, inner, lambda i, y: step(y, *cs), x)

    jax.block_until_ready(chain(x0, *consts))

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(x0, *consts))
        times.append(time.perf_counter() - t0)
    per = np.asarray(times, dtype=float) / inner
    if stats_out is not None:
        stats_out.append(
            (float(per.min()), float(np.median(per)), float(per.max()))
        )
    return float(np.median(per))
