"""Checkpointing, roofline report, and timing utility tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from pint_jax import PackedArray, PackedLayout
from pint_jax.parallel import make_mesh
from pint_jax.utils.checkpoint import (
    load_full,
    load_packed,
    load_sharded,
    load_solver_state,
    save_packed,
    save_sharded,
    save_solver_state,
)
from pint_jax.utils.profiling import op_word_costs, roofline_report
from pint_jax.utils.timing import time_chained


def test_packed_checkpoint_roundtrip(tmp_path):
    lay = PackedLayout(8, 8, 8, 8)
    words = jnp.arange(64, dtype=jnp.uint32)
    arr = PackedArray.from_words(lay, words)
    p = tmp_path / "ckpt.npz"
    save_packed(p, arr)
    back = load_packed(p)
    assert back.layout == lay
    np.testing.assert_array_equal(np.asarray(back.word), np.asarray(words))


def test_solver_state_roundtrip(tmp_path):
    u = np.arange(32, dtype=np.uint32).reshape(2, 16)
    g = np.arange(128, dtype=np.int32).reshape(2, 64)
    p = tmp_path / "state.npz"
    save_solver_state(p, u, g, iters_done=17, meta={"horizon": 50})
    u2, g2, it, meta = load_solver_state(p)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(g, g2)
    assert it == 17 and meta["horizon"] == 50


@pytest.mark.parametrize("dp,tp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_checkpoint_roundtrip(tmp_path, dp, tp):
    """save_sharded writes addressable shards; load_sharded reassembles
    them bit-exactly onto the same sharding."""
    mesh = make_mesh(dp=dp, tp=tp)
    sharding = NamedSharding(mesh, P("dp", "tp"))
    words = np.arange(16 * 8, dtype=np.uint32).reshape(16, 8)
    arr = jax.device_put(jnp.asarray(words), sharding)
    lay = PackedLayout(8, 8, 8, 8)
    prefix = str(tmp_path / "plan")
    path = save_sharded(prefix, PackedArray.from_words(lay, arr))
    assert path.endswith(".proc0.npz")

    back, widths = load_sharded(prefix, sharding)
    assert widths == lay.widths
    assert back.sharding == sharding
    np.testing.assert_array_equal(np.asarray(back), words)

    full, widths2 = load_full(prefix)
    assert widths2 == lay.widths
    np.testing.assert_array_equal(full, words)


def test_sharded_checkpoint_reshard_and_missing(tmp_path):
    """A checkpoint saved on one mesh restores onto another (covering
    shards are sliced); incomplete coverage raises with guidance."""
    coarse = NamedSharding(make_mesh(dp=2, tp=1), P("dp", None))
    fine = NamedSharding(make_mesh(dp=4, tp=2), P("dp", "tp"))
    vals = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    prefix = str(tmp_path / "state")
    save_sharded(prefix, jax.device_put(jnp.asarray(vals), coarse))
    back, widths = load_sharded(prefix, fine)
    assert widths is None
    np.testing.assert_array_equal(np.asarray(back), vals)

    # replicated outputs dedup to one shard per distinct index
    repl = NamedSharding(make_mesh(dp=1, tp=8), P(None, None))
    save_sharded(str(tmp_path / "repl"), jax.device_put(jnp.asarray(vals), repl))
    with np.load(str(tmp_path / "repl") + ".proc0.npz") as z:
        assert int(z["nshards"]) == 1

    # a shard file that covers only half the array cannot serve indices
    # outside it
    import numpy.lib.format  # noqa: F401  (np.load of our own npz)

    half_prefix = str(tmp_path / "half")
    save_sharded(half_prefix, jax.device_put(jnp.asarray(vals), coarse))
    # drop the second half by rewriting the file with only shard 0
    with np.load(half_prefix + ".proc0.npz") as z:
        keep = {
            "shape": z["shape"], "dtype": z["dtype"],
            "nshards": np.int64(1),
            "process_index": z["process_index"],
            "process_count": z["process_count"],
            "data0": z["data0"], "bounds0": z["bounds0"],
        }
    np.savez(half_prefix + ".proc0.npz", **keep)
    with pytest.raises(ValueError, match="cover only"):
        load_sharded(half_prefix, fine)
    with pytest.raises(ValueError, match="cover only"):
        load_full(half_prefix)


def test_roofline_report():
    lay = PackedLayout(8, 8, 8, 8)
    costs = op_word_costs(lay)
    assert costs["add_wrap"] == 6
    rep = roofline_report(
        lay,
        {"add_wrap": 50e9, "add_unsigned_saturate": 40e9, "shift_left": 60e9},
        mem_bytes_per_s=819e9,
        alu_ops_per_s=4e12,
    )
    for op, row in rep.items():
        assert 0 < row["efficiency"] < 2
        assert row["bound"] in ("mem", "alu")
    # shifts stream 2 words, binops 3: the shift memory bound is 1.5x higher
    assert rep["shift_left"]["speed_of_light_Gwords_per_s"] > rep[
        "add_wrap"
    ]["speed_of_light_Gwords_per_s"]


def test_time_chained_measures_order_of_magnitude():
    # on CPU the absolute numbers are meaningless; just verify the utility
    # runs, chains, and returns a positive sane duration
    x = jnp.arange(1 << 16, dtype=jnp.uint32)
    stats = []
    sec = time_chained(lambda v: v + 1, x, inner=8, reps=2, stats_out=stats)
    assert 0 < sec < 1.0
    lo, med, hi = stats[0]
    assert 0 < lo <= med <= hi


def test_compile_cache_respects_env(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    from pint_jax.utils import compile_cache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    monkeypatch.setattr(
        jax.config, "update", lambda *a: calls.append(a)
    )
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Without the variable, the cache is <checkout>/.jax_cache, found
    from the module's own location whatever the working directory."""
    import pathlib

    from pint_jax.utils import compile_cache

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(
        jax.config, "update", lambda *a: calls.append(a)
    )
    monkeypatch.chdir("/")
    checkout = pathlib.Path(__file__).resolve().parents[1]
    expected = str(checkout / ".jax_cache")
    assert compile_cache.enable_compile_cache() == expected
    assert calls == [("jax_compilation_cache_dir", expected)]
