"""Device-mesh utilities.

The reference library has no distributed layer at all (SURVEY.md section 2.4:
the only parallelism is SWAR lanes plus SSE2/NEON baselines in the bench);
scaling here is specified by BASELINE.json: batch data-parallelism plus
psum/all-reduce of condensed-QP gradient blocks across devices.

Everything routes through `jax.sharding.Mesh` + `shard_map`; XLA inserts the
collectives.  Axis convention:

* ``dp`` -- data parallel over QP problems / rollouts (no communication in
  the solve; solves/s scales linearly).
* ``tp`` -- tensor parallel over the condensed horizon dimension: each
  device holds a block-row of the Hessian and a block of the iterate; the
  gradient needs the full iterate, produced by an all-gather.  On one host
  every card reaches every other at the same rate (NVLink), so the mesh is
  plain dp-major with no torus shape to follow.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "host_local_mesh", "P", "NamedSharding"]


def make_mesh(
    dp: Optional[int] = None,
    tp: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A (dp, tp) mesh over the available devices.

    ``dp=None`` consumes all remaining devices.  On a multi-host slice the
    devices enumerate globally (jax.distributed must be initialized by the
    launcher); dp-major ordering keeps tp groups within hosts where
    possible, so the hot all-gather stays off the host network.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"need {dp * tp} devices, have {n}")
    grid = np.asarray(devs[: dp * tp]).reshape(dp, tp)
    return Mesh(grid, ("dp", "tp"))


def host_local_mesh(tp: int = 1) -> Mesh:
    """Mesh over this process's local devices only (single-host runs)."""
    return make_mesh(tp=tp, devices=jax.local_devices())
