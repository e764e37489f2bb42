"""Multi-host initialization and cross-host measurement aggregation.

The reference has no distributed backend (SURVEY.md section 2.4); this module
is the jax.distributed-based equivalent mandated by BASELINE.json: N-host
scaling of MPC solves/s with the gradient psum inside a host and only data
loading across hosts.

Topology notes:

* One process per host; `initialize()` wires the PJRT distributed runtime.
* The (dp, tp) mesh from :func:`pint_jax.parallel.mesh.make_mesh` enumerates
  devices dp-major, so tp groups stay within one host whenever
  ``tp <= local_device_count`` -- the gradient all-reduce never crosses the
  host network in the recommended configuration.  The cards of one host
  reach each other all to all (NVLink), so within a host the mesh shape
  follows the algorithm alone.
* Solves/s is aggregated with :func:`aggregate_rate`: each host measures its
  local batch rate; the global rate is the psum across processes (a tiny
  float all-reduce, off the hot path).

Single-process simulation of a multi-process topology is covered by the unit
suite via ``--xla_force_host_platform_device_count`` (tests/test_parallel.py)
-- the GSPMD partitioning and collective lowering paths are identical; only
the transport differs.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["initialize", "is_multi_process", "aggregate_rate", "process_info"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed from args or the standard env vars.

    No-op when single-process (the common dev case), so the same entry point
    works everywhere.  Under a cluster launcher that JAX recognizes, bare
    ``initialize()`` autodetects everything; elsewhere pass
    ``coordinator_address`` (e.g. ``localhost:<port>``), ``num_processes``
    and ``process_id``.
    """
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    npes = num_processes or _env_int("NUM_PROCESSES")
    pid = process_id if process_id is not None else _env_int("PROCESS_ID")
    if addr is None and npes is None and pid is None:
        try:
            jax.distributed.initialize()
        except Exception:
            # single-process / unmanaged environment
            return
    else:
        jax.distributed.initialize(
            coordinator_address=addr,
            num_processes=npes,
            process_id=pid,
        )


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_multi_process() -> bool:
    return jax.process_count() > 1


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }


def aggregate_rate(local_rate: float) -> float:
    """Global solves/s: sum of each process's locally measured rate.

    Uses a process allgather (one float per host; off the hot path).
    Single-process: returns the input unchanged.
    """
    if not is_multi_process():
        return float(local_rate)
    from jax.experimental import multihost_utils

    rates = multihost_utils.process_allgather(
        jnp.asarray(local_rate, jnp.float32)
    )
    return float(np.asarray(rates).sum())
