"""True multi-process jax.distributed integration (2 and 4 CPU processes).

Validates the real multi-host wiring that the virtual-mesh tests cannot:
process coordination, global device enumeration, cross-process
collectives, the sharded solvers running on a mesh that spans processes
(with real cross-process psums), and per-process sharded checkpointing.
"""

import pathlib
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")

    pid = int(sys.argv[1])
    jax.distributed.initialize(
        coordinator_address="localhost:{port}",
        num_processes={nproc},
        process_id=pid,
    )
    assert jax.process_count() == {nproc}, jax.process_count()
    assert jax.device_count() == {ndev}, jax.device_count()

    import numpy as np
    import jax.numpy as jnp
    from pint_jax.mpc import condense_double_integrator, quantize
    from pint_jax.parallel import ShardedPGD, make_mesh
    from pint_jax.parallel.distributed import aggregate_rate

    qqp = quantize(condense_double_integrator(T=50))
    mesh = make_mesh(dp={dp}, tp={tp})   # spans all processes
    solver = ShardedPGD(qqp, mesh, iters=8)

    from jax.sharding import NamedSharding, PartitionSpec as P

    batch = 8
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-2, 2, batch), rng.uniform(-1, 1, batch)], -1)
    g_host = qqp.g_lane_fixed(x0)
    sharding = NamedSharding(mesh, P("dp", "tp"))
    g = jax.make_array_from_callback(
        g_host.shape, sharding, lambda idx: g_host[idx]
    )
    u0 = jax.make_array_from_callback(
        (batch, qqp.padded // 4),
        sharding,
        lambda idx: np.zeros((batch, qqp.padded // 4), np.uint32)[idx],
    )
    words, residual = solver.solve_words(u0, g)
    r = float(residual)
    assert np.isfinite(r)
    agg = aggregate_rate(100.0)
    assert abs(agg - 100.0 * {nproc}) < 1e-3, agg

    # sharded checkpoint across processes: each host writes ONLY its
    # addressable shards, then reloads onto the same mesh bit-exactly
    from jax.experimental import multihost_utils
    from pint_jax.utils.checkpoint import save_sharded, load_sharded, load_full

    prefix = r"{ckpt_prefix}"
    path = save_sharded(prefix, words)
    assert path.endswith(f".proc{{pid}}.npz"), path
    multihost_utils.sync_global_devices("pint_ckpt_saved")
    back, widths = load_sharded(prefix, sharding)
    assert widths is None
    for s1, s2 in zip(words.addressable_shards, back.addressable_shards):
        assert s1.index == s2.index
        assert (np.asarray(s1.data) == np.asarray(s2.data)).all()
    # both files live on one filesystem here, so the full assembly is
    # checkable too: every addressable shard must match its window
    full, _ = load_full(prefix)
    assert full.shape == words.shape
    for s in words.addressable_shards:
        assert (full[s.index] == np.asarray(s.data)).all()

    # device-resident SQP across the process-spanning mesh: the column
    # inner runs under REAL cross-process psums, and every addressable
    # shard must match the single-device solve bit for bit
    from pint_jax.mpc import DeviceSQP

    dsqp = DeviceSQP(
        horizon=8, sqp_iters=2, pgd_iters=6,
        x_ref=np.array([1.0, 0.0, 0.0]),
    )
    sb = 8
    rng2 = np.random.default_rng(7)
    sx = np.stack(
        [rng2.uniform(-0.2, 0.2, sb), rng2.uniform(-0.2, 0.2, sb),
         rng2.uniform(0, 1, sb)], -1).astype(np.float32)
    w_ref = np.asarray(dsqp.solve_words(dsqp.init_words(sb), sx))
    row = NamedSharding(mesh, P("dp", None))
    wt = NamedSharding(mesh, P("dp", "tp"))
    su = jax.make_array_from_callback(
        (sb, dsqp.n_dec // 4), wt,
        lambda idx: np.zeros((sb, dsqp.n_dec // 4), np.uint32)[idx],
    )
    sxg = jax.make_array_from_callback(sx.shape, row, lambda idx: sx[idx])
    sw = dsqp.sharded_solve_words(mesh)(su, sxg)
    jax.block_until_ready(sw)
    for s in sw.addressable_shards:
        assert (np.asarray(s.data) == w_ref[s.index]).all()
    print(f"proc {{pid}} OK residual={{r}}", flush=True)
    """
)


@pytest.mark.slow
@pytest.mark.parametrize(
    "nproc,dp,tp", [(2, 2, 2), (4, 4, 2)],
    ids=["2proc_dp2tp2", "4proc_dp4tp2"],
)
def test_multi_process_distributed(tmp_path, nproc, dp, tp):
    """2- and 4-process runs: the tp axis spans processes in both (each
    process contributes 2 virtual devices, tp=2 pairs them across the
    dp-major device order), so the in-loop psums cross real process
    boundaries."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    repo = pathlib.Path(__file__).resolve().parents[1]
    script = tmp_path / "worker.py"
    script.write_text(
        WORKER.format(port=port, ckpt_prefix=str(tmp_path / "ckpt"),
                      nproc=nproc, ndev=2 * nproc, dp=dp, tp=tp)
    )

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={
                "PYTHONPATH": str(repo),
                "PATH": "/usr/bin:/bin:/usr/local/bin",
                "HOME": "/tmp",
            },
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert f"proc {pid} OK" in out
