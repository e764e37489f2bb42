"""MPC solves/s scaling sweep over mesh sizes (1 card -> all cards).

BASELINE.json's second headline: >= 80% linear solves/s scaling 1 -> 4
devices on quantized MPC with H=50.  This harness measures solves/s for
growing dp meshes over whatever devices are available:

* on several real cards (one host, or one process per host with
  `pint_jax.parallel.distributed.initialize` wiring jax.distributed;
  rates aggregate across hosts): the actual scaling measurement;
* on a single card or the CPU: a harness smoke test (numbers are not
  hardware-meaningful, but the sweep, sharding and aggregation paths are
  the same).

Usage: python scaling_bench.py [--tp N] [--batch-per-device N] [--cpu]
``--cpu`` selects the virtual-CPU backend (set
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` in the
environment).  Writes chiprun_out/scaling.json and prints one summary
JSON line.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

import jax
import jax.numpy as jnp


def measure(dp: int, tp: int, batch_per_device: int, iters: int):
    from pint_jax.mpc import condense_double_integrator, quantize
    from pint_jax.parallel import ShardedPGD, make_mesh
    from pint_jax.utils.timing import time_chained

    qqp = quantize(condense_double_integrator(T=50))
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[: dp * tp])
    solver = ShardedPGD(qqp, mesh, iters=iters)

    batch = batch_per_device * dp
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(-3, 3, batch), rng.uniform(-1, 1, batch)], axis=-1
    )
    g = solver.place_g(qqp.g_lane_fixed(x0))
    u0 = solver.init_words(batch)

    def step(carry, gg):
        words, _ = solver.solve_words(carry[0], gg)
        return (words, carry[1])

    sec = time_chained(
        step, (u0, jnp.zeros((), jnp.float32)), g,
        inner=32, reps=3,
    )
    return batch / sec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--batch-per-device", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="use the (virtual multi-device) CPU backend")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from pint_jax.parallel.distributed import aggregate_rate, initialize

    initialize()
    n = jax.device_count()

    # stamp the artifact so smoke numbers can't masquerade as measurements:
    # "scaling" over virtual devices sharing one host CPU, or over a single
    # physical chip, is meaningless by construction
    platform = jax.devices()[0].platform
    real_multi_device = platform != "cpu" and n > 1
    environment = {
        "kind": ("multi-device" if real_multi_device else
                 "cpu-virtual-smoke" if platform == "cpu" else
                 f"single-{platform}-smoke"),
        "platform": platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": n,
        "process_count": jax.process_count(),
    }
    if not real_multi_device:
        print(
            "WARNING: no real multi-device hardware -- this run exercises "
            "the sweep/sharding/aggregation paths only; efficiency numbers "
            "are NOT hardware-meaningful",
            flush=True,
        )

    dps = sorted({1, 2, 4, 8, n // args.tp} & set(range(1, n // args.tp + 1)))
    results = {
        "environment": environment,
        "hardware_meaningful": real_multi_device,
        "devices": n,
        "tp": args.tp,
        "sweep": {},
    }
    base = None
    for dp in dps:
        rate = aggregate_rate(
            measure(dp, args.tp, args.batch_per_device, args.iters)
        )
        eff = 1.0 if base is None else rate / (base * dp)
        if base is None:
            base = rate
        results["sweep"][str(dp)] = {
            "solves_per_s": rate,
            "scaling_efficiency": eff,
        }
        print(f"dp={dp}: {rate/1e6:.2f}M solves/s (eff {eff:.2%})", flush=True)

    out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "scaling.json").write_text(json.dumps(results, indent=2))
    last = results["sweep"][str(dps[-1])]
    print(
        json.dumps(
            {
                "metric": f"mpc_scaling_dp{dps[-1]}_tp{args.tp}",
                "value": round(last["solves_per_s"] / 1e6, 3),
                "unit": "Msolves/s",
                "vs_baseline": round(last["scaling_efficiency"], 4),
                "environment": environment["kind"],
                "hardware_meaningful": real_multi_device,
            }
        )
    )


if __name__ == "__main__":
    main()
