"""MPC serving layer: warm starts, validation, self-healing."""

import numpy as np
import pytest

from pint_jax.mpc import condense_double_integrator, quantize
from pint_jax.serving import MPCService


@pytest.fixture(scope="module")
def service():
    qqp = quantize(condense_double_integrator(T=32))
    return MPCService(qqp, batch=8, iters_per_tick=12, use_fused=False)


def test_service_ticks_and_warms(service):
    rng = np.random.default_rng(0)
    x0 = np.stack([rng.uniform(-2, 2, 8), rng.uniform(-1, 1, 8)], axis=-1)
    u1 = service.solve(x0)
    assert u1.shape == (8, 32)
    assert np.abs(u1).max() <= service.qqp.qp.u_max + 1e-9
    # second tick runs warm-started
    u2 = service.solve(x0 * 0.99)
    assert service.stats.ticks == 2
    assert service.stats.last_latency_s > 0


def test_service_rejects_wrong_batch(service):
    with pytest.raises(ValueError):
        service.solve(np.zeros((3, 2)))


def test_service_heals_bad_rows(service):
    x0 = np.zeros((8, 2))
    x0[2, 0] = np.nan
    u = service.solve(x0)
    assert service.stats.resets >= 1
    # the poisoned row returns a safe zero plan
    np.testing.assert_array_equal(u[2], 0.0)
    # subsequent normal ticks continue fine
    u2 = service.solve(np.zeros((8, 2)))
    assert np.isfinite(u2).all()


# -- nonlinear RTI service -----------------------------------------------------


@pytest.fixture(scope="module")
def rti_service():
    from pint_jax.models import Pendulum
    from pint_jax.mpc import DeviceSQP, dare_terminal
    from pint_jax.serving import RTIService

    m = Pendulum(u_shift=10)
    A, B = m.linearize(np.zeros(2), np.zeros(1))
    s = m.lane_scales
    Q = np.diag([1.0, 0.05])
    P = dare_terminal(A, B * s, Q, s[:, None] * np.array([[0.02]]) * s)
    sqp = DeviceSQP(
        model=m, horizon=8, sqp_iters=1, pgd_iters=40,
        Q=Q, R=np.array([[0.02]]), Qf=P, x_ref=np.zeros(2),
    )
    return RTIService(sqp, batch=4), m


def test_rti_service_regulates(rti_service):
    """Driving the quantized plant with the service's per-tick controls
    regulates near-upright starts to ~zero (classic RTI serving loop)."""
    import jax.numpy as jnp

    svc, m = rti_service
    svc.reset()
    state = m.to_fixed(
        np.array([[0.05, 0.0], [-0.06, 0.1], [0.03, -0.1], [0.0, 0.2]])
    )
    state = jnp.asarray(state)
    for _ in range(96):
        x_f = m.to_float(np.asarray(state))
        u_phys = svc.solve(x_f)                   # (4, 1) physical torque
        lanes = np.round(u_phys[:, 0] / m.u_scale).astype(np.int32)
        state = m.step(state, jnp.asarray(lanes))
    final = m.to_float(np.asarray(state))
    assert np.abs(final[:, 0]).max() < 5e-3, final
    assert svc.stats.ticks == 96 and svc.stats.resets == 0


def test_rti_service_self_heals(rti_service):
    svc, m = rti_service
    svc.reset()
    good = np.array([[0.05, 0.0]] * 4)
    svc.solve(good)
    corrupted = good.copy()
    corrupted[2] = np.nan
    u = svc.solve(corrupted)
    assert svc.stats.resets == 1
    assert (u[2] == 0).all()          # corrupted row answers zero control
    assert np.isfinite(u).all()
    # subsequent clean tick proceeds normally
    u2 = svc.solve(good)
    assert np.isfinite(u2).all()


def test_rti_service_batch_mismatch(rti_service):
    svc, _ = rti_service
    with pytest.raises(ValueError, match="batch"):
        svc.solve(np.zeros((3, 2)))


@pytest.fixture(scope="module")
def constrained_rti_service():
    from pint_jax.mpc import DeviceConstrainedSQP, DeviceSQP
    from pint_jax.serving import ConstrainedRTIService

    csqp = DeviceConstrainedSQP(
        DeviceSQP(
            horizon=16, sqp_iters=1, pgd_iters=12,
            x_ref=np.array([1.0, 0.0, 0.0]),
        ),
        F=[[0.0, 1.0, 0.0]], lo=-0.05, hi=0.05, rho=100.0, alm_outer=2,
    )
    return ConstrainedRTIService(csqp, batch=4)


def test_constrained_rti_corridor_held(constrained_rti_service):
    """Closed loop on the f32 plant: the served controls drive toward the
    goal while the lateral corridor is (approximately) held -- warm plans
    and warm multipliers shifting tick to tick."""
    import jax.numpy as jnp

    svc = constrained_rti_service
    svc.reset()
    model = svc.csqp.dev.model
    state = np.array(
        [[0.0, 0.0, 0.6], [0.0, 0.0, -0.6], [0.0, 0.0, 0.2],
         [0.0, 0.0, -0.2]], np.float32,
    )
    ys = []
    for _ in range(48):
        u_phys = svc.solve(state)                    # (4, m) physical
        traj = model.rollout_f32(
            jnp.asarray(state), jnp.asarray(u_phys[:, None, :], jnp.float32)
        )
        state = np.asarray(traj[:, 1])
        ys.append(state[:, 1].copy())
    ys = np.abs(np.stack(ys))
    # the corridor is held through the whole closed loop (small slack for
    # the quantized one-RTI-per-tick budget)
    assert ys.max() < 0.05 + 0.02, ys.max()
    # and the loop actually makes forward progress toward x_ref = 1
    assert state[:, 0].min() > 0.1, state
    assert svc.stats.ticks == 48 and svc.stats.resets == 0


def test_constrained_rti_self_heals(constrained_rti_service):
    svc = constrained_rti_service
    svc.reset()
    good = np.zeros((4, 3)); good[:, 2] = 0.3
    svc.solve(good)
    corrupted = good.copy(); corrupted[1] = np.nan
    u = svc.solve(corrupted)
    assert svc.stats.resets == 1
    assert (u[1] == 0).all()
    assert np.isfinite(u).all()
    u2 = svc.solve(good)
    assert np.isfinite(u2).all()


def test_constrained_rti_batch_mismatch(constrained_rti_service):
    svc = constrained_rti_service
    with pytest.raises(ValueError, match="batch"):
        svc.solve(np.zeros((2, 3)))


def test_mpc_service_device_g_matches_host_g():
    """The device-side linear-term path (g_on_device=True) produces
    controls matching the float64 host path within rounding-tie slack
    (f32 vs f64 can move int32 ties by one lane unit), with identical
    validation/self-heal behavior."""
    import jax.numpy as jnp

    from pint_jax.mpc import condense_double_integrator, quantize
    from pint_jax.serving import MPCService

    qqp = quantize(condense_double_integrator(T=12))
    B = 16
    rng = np.random.default_rng(5)
    x0 = np.stack(
        [rng.uniform(-3, 3, B), rng.uniform(-1, 1, B)], axis=-1
    )
    host = MPCService(qqp, batch=B, iters_per_tick=10, g_on_device=False)
    dev = MPCService(qqp, batch=B, iters_per_tick=10, g_on_device=True)
    u_h = host.solve(x0)
    u_d = dev.solve(x0)
    assert u_h.shape == u_d.shape
    # one lane unit of slack per control (tie movement), same box
    np.testing.assert_allclose(u_d, u_h, atol=2.5 * qqp.u_scale)
    assert np.abs(u_d).max() <= 127 * qqp.u_scale + 1e-9

    # corrupted-state row self-heals identically
    x_bad = x0.copy()
    x_bad[3] = np.nan
    u_bad = dev.solve(x_bad)
    assert np.all(u_bad[3] == 0.0)
    assert dev.stats.resets >= 1


# -- real-time budget (SLO) ----------------------------------------------------


def test_deadline_miss_counter():
    """A tick over the configured budget increments
    ``stats.deadline_misses`` (SLO violation), while the response is
    still returned; a generous budget never misses."""
    from pint_jax.mpc import condense_double_integrator, quantize

    qqp = quantize(condense_double_integrator(T=32))
    # zero budget: every (finite-latency) tick is a forced miss
    svc = MPCService(qqp, batch=4, iters_per_tick=4, use_fused=False,
                     deadline_s=0.0)
    u = svc.solve(np.zeros((4, 2)))
    assert np.isfinite(u).all()
    assert svc.stats.deadline_misses == 1
    svc.solve(np.zeros((4, 2)))
    assert svc.stats.deadline_misses == 2 and svc.stats.ticks == 2

    # generous budget: no misses
    ok = MPCService(qqp, batch=4, iters_per_tick=4, use_fused=False,
                    deadline_s=60.0)
    ok.solve(np.zeros((4, 2)))
    assert ok.stats.deadline_misses == 0

    # no budget configured: counter stays untouched
    off = MPCService(qqp, batch=4, iters_per_tick=4, use_fused=False,
                     deadline_s=None)
    off.solve(np.zeros((4, 2)))
    assert off.stats.deadline_misses == 0


def test_default_budgets_defined():
    """Every endpoint ships a defined real-time budget (BASELINE.json
    north-star: controls must match the reference under the same horizon
    AND real-time budget)."""
    from pint_jax.serving import (
        CRTI_BUDGET_S, LTI_BUDGET_S, RTI_BUDGET_S,
    )

    assert LTI_BUDGET_S == 0.010            # 100 Hz loop
    assert RTI_BUDGET_S == 0.020            # 50 Hz loop
    assert CRTI_BUDGET_S == 0.020           # 50 Hz loop


def test_rti_deadline_miss_counter():
    from pint_jax.models import Pendulum
    from pint_jax.mpc import DeviceSQP
    from pint_jax.serving import RTIService

    m = Pendulum(u_shift=10)
    sqp = DeviceSQP(model=m, horizon=8, sqp_iters=1, pgd_iters=6,
                    Q=np.diag([1.0, 0.05]), R=np.array([[0.02]]),
                    x_ref=np.zeros(2))
    svc = RTIService(sqp, batch=4, deadline_s=0.0)
    svc.solve(np.zeros((4, 2)))
    assert svc.stats.deadline_misses == 1
