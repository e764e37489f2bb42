from pint_jax.mpc.condensed import (
    CondensedQP,
    QuantizedQP,
    condense_double_integrator,
    condense_lti,
    condense_ltv,
    dare_terminal,
    quantize,
)
from pint_jax.mpc.accelerated import AcceleratedPGD
from pint_jax.mpc.constrained import (
    ConstrainedController,
    ConstrainedPGD,
    StateConstrainedQP,
    constrain_states,
    quantize_constrained,
)
from pint_jax.mpc.controller import LTIController, RecedingHorizonController
from pint_jax.mpc.device_constrained import DeviceConstrainedSQP
from pint_jax.mpc.device_sqp import DeviceSQP
from pint_jax.mpc.fused import FusedPGD
from pint_jax.mpc.ltv import QuantizedSQP, SQPController
from pint_jax.mpc.mppi import QuantizedMPPI, unicycle_goal_cost
from pint_jax.mpc.nonlinear import QuantizedNonlinearPGD
from pint_jax.mpc.solver import FixedPointPGD
from pint_jax.mpc.sqp_constrained import ConstrainedSQP

__all__ = [
    "CondensedQP",
    "QuantizedQP",
    "condense_double_integrator",
    "condense_lti",
    "condense_ltv",
    "dare_terminal",
    "quantize",
    "FixedPointPGD",
    "AcceleratedPGD",
    "ConstrainedController",
    "ConstrainedPGD",
    "StateConstrainedQP",
    "constrain_states",
    "quantize_constrained",
    "FusedPGD",
    "RecedingHorizonController",
    "LTIController",
    "QuantizedMPPI",
    "QuantizedNonlinearPGD",
    "QuantizedSQP",
    "DeviceConstrainedSQP",
    "DeviceSQP",
    "SQPController",
    "ConstrainedSQP",
    "unicycle_goal_cost",
]
