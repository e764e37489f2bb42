"""Checkpoint/resume for solver state.

The reference library is stateless (SURVEY.md section 5: no
checkpoint/resume subsystem); for this framework the persistent state is the
MPC iterate -- packed control words plus the quantized-QP description -- and
long batched sweeps want cheap periodic snapshots.

Format: a single ``.npz`` with the packed words (bit-exact uint words), the
lane widths, and solver metadata.  Orbax is intentionally not required: the
state is a flat pytree of integer arrays, np.savez is bit-exact, dependency-
free and multi-host friendly: :func:`save_sharded` has every process write
ONLY its addressable shards to ``{prefix}.proc{K}.npz`` (no cross-host
gather), and :func:`load_sharded` reassembles a global array onto a target
sharding from whichever shard files each process can see
(tests/test_utils.py on a virtual mesh; tests/test_multiprocess.py across
two real processes).
"""

from __future__ import annotations

import glob
import json
from typing import Optional, Tuple

import numpy as np

from pint_jax.layout import PackedLayout
from pint_jax.packed import PackedArray

__all__ = [
    "save_packed",
    "load_packed",
    "save_solver_state",
    "load_solver_state",
    "save_sharded",
    "load_sharded",
    "load_full",
]


def save_packed(path, arr: PackedArray) -> None:
    """Snapshot a PackedArray (words + layout) to ``path``.npz."""
    np.savez(
        path,
        words=np.asarray(arr.word),
        widths=np.asarray(arr.layout.widths, np.int64),
    )


def load_packed(path) -> PackedArray:
    with np.load(path) as z:
        layout = PackedLayout(*[int(w) for w in z["widths"]])
        words = z["words"]
    import jax.numpy as jnp

    return PackedArray.from_words(layout, jnp.asarray(words))


def save_solver_state(
    path,
    u_words,
    g_pre,
    *,
    iters_done: int,
    meta: Optional[dict] = None,
) -> None:
    """Snapshot an in-flight PGD solve (iterate + linear term + progress).

    On multi-host runs, pass this host's addressable shard and a per-host
    path; the words are integer-exact so resume reproduces the exact
    trajectory the uninterrupted solve would have taken (the iteration is
    deterministic, tests/test_parallel.py).
    """
    np.savez(
        path,
        u_words=np.asarray(u_words),
        g_pre=np.asarray(g_pre),
        iters_done=np.int64(iters_done),
        meta=json.dumps(meta or {}),
    )


def load_solver_state(path) -> Tuple[np.ndarray, np.ndarray, int, dict]:
    with np.load(path) as z:
        return (
            z["u_words"],
            z["g_pre"],
            int(z["iters_done"]),
            json.loads(str(z["meta"])),
        )


# ---------------------------------------------------------------------------
# Sharded (multi-host) checkpoints
# ---------------------------------------------------------------------------


def _norm_index(index, shape) -> Tuple[Tuple[int, int], ...]:
    """Shard index (tuple of slices) -> hashable ((start, stop), ...)."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append((start, stop))
    return tuple(out)


def save_sharded(prefix, arr) -> str:
    """Save THIS process's addressable shards of a global jax.Array.

    Writes ``{prefix}.proc{K}.npz`` (K = ``jax.process_index()``) holding
    each distinct addressable shard's data plus its global index bounds,
    the global shape/dtype, and the lane widths when ``arr`` is a
    :class:`PackedArray`.  No cross-host communication: on an N-host run
    every host calls this with the same prefix and writes only its own
    file.  Returns the path written.
    """
    import jax

    widths = None
    if isinstance(arr, PackedArray):
        widths = np.asarray(arr.layout.widths, np.int64)
        arr = arr.word
    shape = arr.shape
    seen = {}
    for shard in arr.addressable_shards:
        key = _norm_index(shard.index, shape)
        if key not in seen:
            seen[key] = np.asarray(shard.data)
    payload = {
        "shape": np.asarray(shape, np.int64),
        "dtype": np.str_(np.dtype(arr.dtype).str),
        "nshards": np.int64(len(seen)),
        "process_index": np.int64(jax.process_index()),
        "process_count": np.int64(jax.process_count()),
    }
    if widths is not None:
        payload["widths"] = widths
    for i, (key, data) in enumerate(sorted(seen.items())):
        payload[f"data{i}"] = data
        payload[f"bounds{i}"] = np.asarray(key, np.int64)  # (ndim, 2)
    path = f"{prefix}.proc{int(jax.process_index())}.npz"
    np.savez(path, **payload)
    return path


def _read_shard_files(prefix):
    """All shard files visible to this process -> (shape, dtype, widths,
    {bounds: data})."""
    paths = sorted(glob.glob(f"{prefix}.proc*.npz"))
    if not paths:
        raise FileNotFoundError(f"no shard files match {prefix}.proc*.npz")
    shape = dtype = widths = None
    shards = {}
    for path in paths:
        with np.load(path) as z:
            fshape = tuple(int(d) for d in z["shape"])
            fdtype = np.dtype(str(z["dtype"]))
            if shape is None:
                shape, dtype = fshape, fdtype
            elif (fshape, fdtype) != (shape, dtype):
                raise ValueError(
                    f"{path}: shape/dtype {fshape}/{fdtype} disagrees with "
                    f"{shape}/{dtype} from earlier shard files"
                )
            if "widths" in z:
                widths = tuple(int(w) for w in z["widths"])
            for i in range(int(z["nshards"])):
                key = tuple(
                    (int(a), int(b)) for a, b in z[f"bounds{i}"]
                )
                shards[key] = z[f"data{i}"]
    return shape, dtype, widths, shards


def load_sharded(prefix, sharding):
    """Restore a :func:`save_sharded` checkpoint onto ``sharding``.

    Each process reads the ``{prefix}.proc*.npz`` files it can see and
    places the shards its addressable devices need — the natural multi-host
    restore where host K reads (at least) the file host K wrote.  The
    target mesh may differ from the saving mesh as long as every needed
    device index is covered by some saved shard (exact-match or containing
    shard; bit-exact either way).  Returns (jax.Array, widths-or-None):
    wrap with ``PackedArray.from_words(PackedLayout(*widths), arr)`` for
    packed checkpoints.
    """
    import jax

    shape, dtype, widths, shards = _read_shard_files(prefix)
    device_indices = sharding.addressable_devices_indices_map(shape)
    arrays = []
    for device, index in device_indices.items():
        key = _norm_index(index, shape)
        if key in shards:
            data = shards[key]
        else:
            data = _assemble_window(shards, key, np.dtype(dtype), prefix)
        arrays.append(jax.device_put(data, device))
    arr = jax.make_array_from_single_device_arrays(shape, sharding, arrays)
    return arr, widths


def _assemble_window(shards, key, dtype, prefix):
    """Assemble the target window ``key`` from intersecting saved shards.

    Handles arbitrary resharding: the save-time tiling need not align with
    the restore-time tiling as long as the visible shard files jointly
    cover the window."""
    out = np.zeros([b - a for a, b in key], dtype)
    filled = np.zeros(out.shape, bool)
    for skey, data in shards.items():
        isect = [
            (max(t0, s0), min(t1, s1))
            for (t0, t1), (s0, s1) in zip(key, skey)
        ]
        if any(a >= b for a, b in isect):
            continue
        dst = tuple(
            slice(a - t0, b - t0) for (a, b), (t0, _) in zip(isect, key)
        )
        src = tuple(
            slice(a - s0, b - s0) for (a, b), (s0, _) in zip(isect, skey)
        )
        out[dst] = data[src]
        filled[dst] = True
    if not filled.all():
        raise ValueError(
            f"{prefix}: saved shards cover only {int(filled.sum())} of "
            f"{filled.size} elements of index {key} needed by the target "
            f"sharding; copy the other hosts' shard files here or re-save "
            f"on a compatible mesh (saved: {sorted(shards)})"
        )
    return out


def load_full(prefix) -> Tuple[np.ndarray, Optional[tuple]]:
    """Assemble the FULL array from all visible shard files (host-side
    inspection / resharding entry).  Requires complete coverage.  Returns
    (numpy array, widths-or-None)."""
    shape, dtype, widths, shards = _read_shard_files(prefix)
    out = np.zeros(shape, dtype)
    filled = np.zeros(shape, bool)
    for key, data in shards.items():
        sl = tuple(slice(a, b) for a, b in key)
        out[sl] = data
        filled[sl] = True
    if not filled.all():
        raise ValueError(
            f"{prefix}: shard files cover only {int(filled.sum())} of "
            f"{filled.size} elements; gather every host's file first"
        )
    return out, widths
