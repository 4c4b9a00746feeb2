"""The port's rates controller and ANGLE/HORIZON flight modes against the
JAX package's (``fpyv_tpu.control``) on the CPU, and the rates controller
against the float64 oracle (``tools/oracle/sim.py::OracleRatesController``).

Tolerances: the rates controller 1e-10 absolute in float64 against both
(JAX's own test's tolerance against the oracle); one flight-mode step from
the same float32 state 1e-5 absolute on the action (atan2/asin of float32
angles, the stick x max_angle product rounded once in each); the closed
loop through ``drone_step`` (240 float32 steps) 1e-3 on the attitude, a
self-levelling loop that shrinks its differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.control import flight_modes as jfm
from fpyv_tpu.control import rates_controller as jrc
from fpyv_tpu.ops import rotations as jrot
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.physics.drone import drone_reset as j_reset
from fpyv_tpu.physics.drone import drone_step as j_step
from fpyv_tpu.physics.world import empty_world as j_empty_world
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.control import (FlightModeParams, RatesControllerParams, angle_mode_action,
                                    flight_mode_init, horizon_mode_action,
                                    rates_controller_init, rates_controller_step)
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.physics.drone import DroneParams, drone_reset, drone_step
from fpyv_tpu_torch.physics.world import empty_world
from tools.oracle.sim import OracleRatesController, euler_to_R

HOVER_THROTTLE = -0.646  # thrust ~= weight for the default F80 curve


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Rates controller
# ---------------------------------------------------------------------------


def test_rates_controller_matches_oracle_and_jax():
    params = RatesControllerParams(gain=30.0, max_rates=480.0, state_transition_coef=0.75,
                                   goal_transition_coef=0.9, error_transition_coef=0.9)
    jparams = jrc.RatesControllerParams(30.0, 480.0, 0.75, 0.9, 0.9)
    oracle = OracleRatesController(30.0, 480.0, 0.75, 0.9, 0.9)
    rng = np.random.default_rng(2)
    st = rates_controller_init((), torch.float64, "cpu")
    jst = jrc.rates_controller_init((), jnp.float64)
    for _ in range(100):
        Rc, Rg = euler_to_R(*rng.uniform(-1, 1, 3)), euler_to_R(*rng.uniform(-1, 1, 3))
        st, rates, err = rates_controller_step(params, st, torch.from_numpy(Rc),
                                               torch.from_numpy(Rg))
        jst, jrates, jerr = jrc.rates_controller_step(jparams, jst, jnp.asarray(Rc),
                                                      jnp.asarray(Rg))
        np.testing.assert_allclose(rates.numpy(), oracle.get_rates(Rc, Rg), atol=1e-10, rtol=0)
        np.testing.assert_allclose(rates.numpy(), np.asarray(jrates), atol=1e-10, rtol=0)
        np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-10, rtol=0)
    for f in ("prev_state", "prev_goal", "prev_error"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(jst, f)),
                                   atol=1e-10, rtol=0)


def test_rates_controller_batched_and_interop():
    """A bank of 32 controllers equals each one alone, and the state carries
    across to and from JAX's."""
    rng = np.random.default_rng(3)
    Rc = torch.from_numpy(np.stack([euler_to_R(*e) for e in rng.uniform(-1, 1, (32, 3))]))
    Rg = torch.from_numpy(np.stack([euler_to_R(*e) for e in rng.uniform(-1, 1, (32, 3))]))
    p = RatesControllerParams()
    st, rates, _ = rates_controller_step(p, rates_controller_init((32,), torch.float64, "cpu"),
                                         Rc, Rg)
    for i in (0, 17, 31):
        _, r1, _ = rates_controller_step(p, rates_controller_init((), torch.float64, "cpu"),
                                         Rc[i], Rg[i])
        np.testing.assert_allclose(rates[i].numpy(), r1.numpy(), atol=1e-12)
    jst = jrc.rates_controller_init((32,), jnp.float64)
    jst, jrates, _ = jax.vmap(lambda s, a, b: jrc.rates_controller_step(
        jrc.RatesControllerParams(), s, a, b))(jst, jnp.asarray(Rc.numpy()),
                                               jnp.asarray(Rg.numpy()))
    back = interop.rates_controller_state_from_numpy(interop.to_numpy_tree(jst), "cpu")
    for f in ("prev_state", "prev_goal", "prev_error"):
        np.testing.assert_allclose(getattr(back, f).numpy(), getattr(st, f).numpy(), atol=1e-10)
    assert interop.rates_controller_state_to_numpy(st)["prev_goal"].shape == (32, 3)


def test_rates_controller_converges_in_rotate_loop():
    params = RatesControllerParams(gain=30.0, max_rates=480.0)
    rng = np.random.default_rng(3)
    goal = rot.euler_to_rotmat(torch.from_numpy(rng.uniform(-0.8, 0.8, 3)))
    cur = rot.euler_to_rotmat(torch.from_numpy(rng.uniform(-0.8, 0.8, 3)))
    st = rates_controller_init((), torch.float64, "cpu")

    def err(c):
        return float(((rot.mat3_mul(goal.T, c) - torch.eye(3, dtype=c.dtype)) ** 2).sum())

    e0 = err(cur)
    for _ in range(300):
        st, rates, _ = rates_controller_step(params, st, cur, goal)
        cur = rot.rotate_body_by_rates(cur, rates, 1 / 60)
    assert err(cur) < 1e-4 * max(e0, 1.0), (e0, err(cur))


# ---------------------------------------------------------------------------
# ANGLE / HORIZON
# ---------------------------------------------------------------------------

TILTS = [[35.0, -20.0, 10.0], [-40.0, 30.0, 0.0], [10.0, 44.0, -90.0], [-25.0, -35.0, 170.0]]


def _sticks(n, **cols):
    s = np.zeros((n, 4), np.float32)
    s[:, 3] = HOVER_THROTTLE
    for c, v in cols.items():
        s[:, "rpy".index(c)] = v
    return s


@pytest.mark.parametrize("mode", ["angle", "horizon"])
def test_mode_step_matches_jax(mode):
    """Three steps of the mode from the same attitudes and sticks, the
    controller's memory carried: the acro actions and the memory agree."""
    rng = np.random.default_rng(0)
    R = np.array(jrot.euler_to_rotmat(jnp.asarray(rng.uniform(-0.7, 0.7, (64, 3)),
                                                    jnp.float32)))
    sticks = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    sticks[:8, :3] = 0.0  # centred: pure self-level
    jfn = jfm.angle_mode_action if mode == "angle" else jfm.horizon_mode_action
    tfn = angle_mode_action if mode == "angle" else horizon_mode_action
    jp, tp = jfm.FlightModeParams(), FlightModeParams()
    js, ts = jfm.flight_mode_init((64,)), flight_mode_init((64,), device="cpu")
    for _ in range(3):
        js, ja = jfn(jp, js, jnp.asarray(R), jnp.asarray(sticks))
        ts, ta = tfn(tp, ts, torch.from_numpy(R), torch.from_numpy(sticks))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=0)
    back = interop.flight_mode_state_to_numpy(ts)["controller"]
    for f, v in interop.to_numpy_tree(js)["controller"].items():
        np.testing.assert_allclose(back[f], v, atol=1e-5)


def _fly_torch(mode_fn, sticks, ypr0, steps):
    params = DroneParams(att_mode="rotmat")
    world = empty_world(ground=True, device="cpu")
    fm = FlightModeParams(max_rates=params.max_rates)
    n = sticks.shape[0]
    state = drone_reset(params, torch.tensor([[0.0, 0.0, 30.0]]).repeat(n, 1), torch.zeros(n, 3),
                        torch.tensor(ypr0, dtype=torch.float32))
    fs = flight_mode_init((n,), device="cpu")
    sticks = torch.from_numpy(sticks)
    for _ in range(steps):
        fs, action = mode_fn(fm, fs, state.att, sticks)
        state, _ = drone_step(params, state, action, world)
    return state


def _fly_jax(mode_fn, sticks, ypr0, steps):
    params = JP(att_mode="rotmat")
    world = j_empty_world(ground=True)
    fm = jfm.FlightModeParams(max_rates=params.max_rates)
    n = sticks.shape[0]
    state = j_reset(params, jnp.tile(jnp.asarray([0.0, 0.0, 30.0], jnp.float32), (n, 1)),
                    jnp.zeros((n, 3), jnp.float32), jnp.asarray(ypr0, jnp.float32))

    def body(carry, _):
        st, fs = carry
        fs, action = mode_fn(fm, fs, st.att, jnp.asarray(sticks))
        st, _ = j_step(params, st, action, world)
        return (st, fs), None

    return jax.jit(lambda s, f: jax.lax.scan(body, (s, f), None, length=steps)[0][0])(
        state, jfm.flight_mode_init((n,)))


def test_angle_mode_self_levels_like_jax():
    """tests/test_flight_modes.py's tilts, 240 steps of ANGLE mode with
    centred sticks through ``drone_step``: both packages level the bank
    (roll and pitch below 2°, no crash) and agree on the attitude."""
    sticks = _sticks(4)
    ts = _fly_torch(angle_mode_action, sticks, TILTS, 240)
    js = _fly_jax(jfm.angle_mode_action, sticks, TILTS, 240)
    euler = np.rad2deg(rot.rotmat_to_euler(ts.att).numpy())
    assert np.abs(euler[:, :2]).max() < 2.0, euler
    assert not ts.done.any()
    np.testing.assert_allclose(ts.att.numpy(), np.asarray(js.att), atol=1e-3)


def test_horizon_full_stick_is_acro_and_half_stick_blends():
    sticks = _sticks(1, r=1.0)
    ts = _fly_torch(horizon_mode_action, sticks, [[0.0, 0.0, 0.0]], 40)
    np.testing.assert_allclose(ts.rates[0, 0].item(), -DroneParams().max_rates, rtol=1e-3)
    R = rot.euler_to_rotmat(torch.zeros(1, 3))
    st = flight_mode_init((1,), device="cpu")
    _, a_half = horizon_mode_action(FlightModeParams(), st, R, torch.tensor([[0.5, 0, 0, 0.0]]))
    _, a_full = horizon_mode_action(FlightModeParams(), st, R, torch.tensor([[1.0, 0, 0, 0.0]]))
    assert 0.0 < a_half[0, 0].item() < a_full[0, 0].item() == 1.0
    # at full deflection HORIZON passes the sticks through as acro's action
    full = torch.tensor([[1.0, -1.0, 0.3, HOVER_THROTTLE]])
    _, a = horizon_mode_action(FlightModeParams(), st, R, full)
    np.testing.assert_allclose(a.numpy(), full.numpy(), atol=1e-7)


def test_angle_full_stick_and_yaw_rate():
    st = _fly_torch(angle_mode_action, _sticks(1, r=1.0), [[0.0, 0.0, 0.0]], 300)
    assert 40.0 < np.rad2deg(rot.rotmat_to_euler(st.att).numpy())[0, 0] < 50.0
    st = _fly_torch(angle_mode_action, _sticks(1, y=0.5), [[0.0, 0.0, 0.0]], 60)
    np.testing.assert_allclose(st.rates[0, 2].item(), -0.5 * FlightModeParams().max_yaw_rate,
                               rtol=0.05)


def test_mode_does_not_write_the_controller_output():
    """The yaw channel is a new tensor, not a write into the rates the
    controller returned (the caller may hold them)."""
    R = rot.euler_to_rotmat(torch.zeros(2, 3))
    st = flight_mode_init((2,), device="cpu")
    sticks = torch.tensor([[0.2, 0.1, 0.7, 0.0], [0.0, 0.0, -0.4, 0.0]])
    before = sticks.clone()
    angle_mode_action(FlightModeParams(), st, R, sticks)
    assert torch.equal(sticks, before) and torch.equal(st.controller.prev_error,
                                                       torch.zeros(2, 3))
