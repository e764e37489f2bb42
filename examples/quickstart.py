"""pint-jax quickstart: packed lanes, rollouts, MPC, sharding.

Run: python examples/quickstart.py  (CPU or GPU)
"""

import os
import sys

# run from a checkout without installing: python examples/quickstart.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import pint_jax as pt


def swar_basics():
    print("== SWAR basics ==")
    lay = pt.PackedLayout(5, 6, 5)          # make_packed_int<5,6,5>
    a = pt.PackedArray.pack(lay, 1, 20, 10)
    b = pt.PackedArray.pack(lay, 30, 60, 20)
    print("a        ", a.lanes().tolist())
    print("wrap     ", pt.add_wrap(a, b).lanes().tolist())
    print("sat-u    ", pt.add_unsigned_saturate(a, b).lanes().tolist())
    print("min-u    ", pt.min_unsigned(a, b).lanes().tolist())
    print("shift<<2 ", pt.shift_left(a, 2).lanes().tolist())

    # the accelerator-natural shape: tensors of packed words
    words = jnp.arange(1 << 16, dtype=jnp.uint32)
    x = pt.PackedArray.from_words(pt.PackedLayout(8, 8, 8, 8), words)
    y = pt.add_signed_saturate(x, x)
    print("batched  ", y.shape, y.dtype)


def quantized_rollouts():
    print("\n== Quantized rollouts (8192 x H=50) ==")
    from pint_jax.models import DoubleIntegrator, pack_controls

    model = DoubleIntegrator()
    rng = np.random.default_rng(0)
    lanes = jnp.asarray(rng.integers(-128, 128, (8192, 52), dtype=np.int32))
    words = pack_controls(lanes)            # int8 lanes 4-per-uint32
    states = jax.jit(model.rollout_packed)(
        jnp.zeros((8192, 2), jnp.int32), words
    )
    print("states   ", states.shape, "final p[0] =",
          model.to_float(states[0, -1, 0]))


def fixed_point_mpc():
    print("\n== Fixed-point MPC ==")
    from pint_jax.mpc import (
        FixedPointPGD,
        condense_double_integrator,
        quantize,
    )

    qp = condense_double_integrator(T=50)
    solver = FixedPointPGD(quantize(qp), iters=40)
    x0 = np.array([[2.0, 0.0], [-1.0, 0.5]])
    _, u = solver.solve(x0)
    print("controls ", np.asarray(u)[:, :6].round(3))
    print("cost     ", solver.cost(np.asarray(u), x0).round(4))


def sharded_mpc():
    print("\n== Sharded MPC (dp x tp) ==")
    if jax.device_count() < 2:
        print("(single device; skipping)")
        return
    from pint_jax.mpc import condense_double_integrator, quantize
    from pint_jax.parallel import ShardedPGD, make_mesh

    tp = 2 if jax.device_count() % 2 == 0 else 1
    mesh = make_mesh(tp=tp)
    solver = ShardedPGD(quantize(condense_double_integrator(T=50)), mesh,
                        iters=40)
    x0 = np.array([[2.0, 0.0], [-1.0, 0.5], [0.5, 1.0], [0.0, -1.0]])
    _, u, residual = solver.solve(x0)
    print("mesh     ", dict(mesh.shape))
    print("residual ", float(residual))


if __name__ == "__main__":
    swar_basics()
    quantized_rollouts()
    fixed_point_mpc()
    sharded_mpc()
