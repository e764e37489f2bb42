"""Integer-overflow discipline tests (SURVEY.md section 5: the analog of the
reference's UB-defensive testing -- volatile shifts, UB-free all_ones).

Extreme-value sweeps through every int32 fixed-point path: the documented
range guarantees must hold at the boundaries, not just for typical inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pint_jax.models import DoubleIntegrator, Unicycle
from pint_jax.mpc import FixedPointPGD, condense_double_integrator, quantize


def test_solver_accumulator_bound_at_extremes():
    """|acc| <= 127*127*Tp by construction; hs_num chosen so acc*hs_num
    fits int32.  Drive the solver with worst-case lanes and linear term."""
    qqp = quantize(condense_double_integrator(T=50))
    acc_max = 127 * 127 * qqp.padded
    assert acc_max * qqp.hs_num < 2**31

    solver = FixedPointPGD(qqp, iters=30)
    batch = 16
    # worst-case linear term: int32 extremes (as g_lane_fixed can emit
    # after clipping)
    g = jnp.full((batch, qqp.padded), 2**31 - 1, jnp.int32)
    out = jax.jit(solver.solve_words)(solver.init_words(batch), g)
    # all lanes driven to the box floor, never past it
    from pint_jax.models.dynamics import unpack_controls

    l = np.asarray(unpack_controls(out))
    assert l.min() >= -127 and l.max() <= 127

    g2 = jnp.full((batch, qqp.padded), -(2**31), jnp.int32)
    out2 = jax.jit(solver.solve_words)(solver.init_words(batch), g2)
    l2 = np.asarray(unpack_controls(out2))
    assert l2.min() >= -127 and l2.max() <= 127


def test_double_integrator_extreme_states_no_trap():
    """Saturating lanes + extreme states: wrapping is defined (int32 ring),
    and within the documented operating range results stay exact."""
    model = DoubleIntegrator()
    # documented range: |v| < 2^31 / 1 (additions only) -- just check the
    # step is total (no NaN-like failure modes exist for ints) and exact
    # at the positive/negative extremes of the control range
    state = jnp.asarray([[2**28, -(2**28)]], jnp.int32)
    for lane in (-128, 127):
        nxt = model.step(state, jnp.asarray([lane], jnp.int32))
        assert nxt.shape == (1, 2)
        # v' = v + u*dt exactly
        expected_v = -(2**28) + ((lane << model.u_shift) >> model.dt_shift)
        assert int(nxt[0, 1]) == expected_v


def test_unicycle_trig_bounds():
    """Q14 trig stays within [-2^14, 2^14] for every Q16 angle."""
    from pint_jax.models.dynamics import _sin_turns_q14

    theta = jnp.arange(-(1 << 17), 1 << 17, 97, dtype=jnp.int32)
    s = np.asarray(_sin_turns_q14(theta))
    assert s.min() >= -(1 << 14) and s.max() <= (1 << 14)


def test_unicycle_product_bound():
    """(v_fp >> 2) * cos_q14 fits int32 at the extremes of the validated
    shift range."""
    model = Unicycle(v_shift=10)  # max permitted
    state = jnp.asarray([[0, 0, 1 << 14]], jnp.int32)  # quarter turn
    nxt = model.step(
        state, jnp.asarray([127], jnp.int32), jnp.asarray([-128], jnp.int32)
    )
    assert nxt.shape == (1, 3)
    # no silent wrap: |dx| must be <= v*dt in fixed point
    assert abs(int(nxt[0, 0])) <= (127 << model.v_shift) >> model.dt_shift


def test_quantize_rejects_degenerate_scale():
    import pytest

    from pint_jax.mpc.condensed import CondensedQP, quantize as q

    tiny = CondensedQP(
        H=np.eye(4) * 1e-30,
        G=np.zeros((4, 2)),
        g_ref=np.zeros(4),
        u_max=1.0,
        lipschitz=1e30,  # forces h_scale ~ 1e-60 -> hs_num underflow
    )
    with pytest.raises(ValueError):
        q(tiny)
