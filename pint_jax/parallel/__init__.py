from pint_jax.parallel.mesh import host_local_mesh, make_mesh
from pint_jax.parallel.solver import ShardedConstrainedPGD, ShardedPGD

__all__ = [
    "make_mesh",
    "host_local_mesh",
    "ShardedPGD",
    "ShardedConstrainedPGD",
]
