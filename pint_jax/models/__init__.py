from pint_jax.models.quadrotor import PlanarQuadrotor
from pint_jax.models.dynamics import (
    CONTROL_LAYOUT,
    DoubleIntegrator,
    Unicycle,
    pack_controls,
    unpack_controls,
)
from pint_jax.models.pendulum import Pendulum

__all__ = [
    "CONTROL_LAYOUT",
    "DoubleIntegrator",
    "Unicycle",
    "PlanarQuadrotor",
    "Pendulum",
    "pack_controls",
    "unpack_controls",
]
