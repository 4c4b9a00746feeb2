"""The port's secondary envs against the JAX package's on the CPU:
``SensorAcroEnv``, ``HoverEnv`` with its ``HoverPilot``, ``BallEnv`` with
``ProportionalNavigation``, and ``MaComGridEnv``. JAX runs one env vmapped
over keys; the port runs the bank. JAX's threefry draws are reproduced
outside its envs and fed through the port's draw functions
(``sensors.imu.imu_noise``, ``sensors.baro.pressure_noise``,
``sensors.uwb.range_noise``, ``envs.hover.reset_draws``,
``envs.ball.reset_draws``, ``envs.ball.random_actions``,
``envs.gridworld.reset_draws``); the acro env's own resets inside
``SensorAcroEnv`` are JAX's reset states fed through ``AcroEnv._fresh``.

Tolerances: ``SensorAcroEnv`` 1e-4 absolute on the float32 observation
(the barometer's float32 pressure near 1e5 Pa moves by an ulp of exp,
0.008 Pa, which is 7e-4 m of altitude and 3e-5 of the observation after
its /20) and 1e-5 on the acro state, reward and action memory; the hover
env 1e-5 on a step (float32 physics) and 2e-3 m on the position after the
pilot's 600 closed-loop steps; ``BallEnv`` and ``MaComGridEnv`` states
equal, observations 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JAcro
from fpyv_tpu.envs.acro import AcroState as JAcroState
from fpyv_tpu.envs.ball import BallEnv as JBall
from fpyv_tpu.envs.ball import ProportionalNavigation as JPropNav
from fpyv_tpu.envs.gridworld import MaComGridEnv as JGrid
from fpyv_tpu.envs.hover import HoverEnv as JHover
from fpyv_tpu.envs.hover import HoverPilot as JPilot
from fpyv_tpu.envs.sensor_acro import SensorAcroEnv as JSensor
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs import ball as tball
from fpyv_tpu_torch.envs import gridworld as tgrid
from fpyv_tpu_torch.envs import hover as thover
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.ball import BallEnv, ProportionalNavigation, PropNavState
from fpyv_tpu_torch.envs.gridworld import MaComGridEnv
from fpyv_tpu_torch.envs.hover import HoverEnv, HoverPilot
from fpyv_tpu_torch.envs.sensor_acro import SensorAcroEnv
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.sensors import baro as tbaro
from fpyv_tpu_torch.sensors import imu as timu
from fpyv_tpu_torch.sensors import uwb as tuwb

N = 32


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol):
    """Two trees of the same fields (the port's dataclass, JAX's struct)."""
    ta, tb = interop.to_numpy_tree(a), interop.to_numpy_tree(b)

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}.{k}")
        elif x.dtype.kind in "biu":
            np.testing.assert_array_equal(x, y, err_msg=path)
        else:
            np.testing.assert_allclose(x, y, atol=atol, rtol=0, err_msg=path)

    walk(ta, tb, "")


# ---------------------------------------------------------------------------
# SensorAcroEnv
# ---------------------------------------------------------------------------


def _jax_obs_draws(keys):
    """JAX's observation draws per env: IMU accel and gyro (``ka, kg`` of
    ``ki``), baro (``kb``), UWB (``ku``)."""
    def one(k):
        ki, kb, ku = jax.random.split(k, 3)
        ka, kg = jax.random.split(ki)
        return (jax.random.normal(ka, (3,), jnp.float32), jax.random.normal(kg, (3,), jnp.float32),
                jax.random.normal(kb, (), jnp.float32), jax.random.normal(ku, (), jnp.float32))

    return jax.vmap(one)(keys)


def _feed_obs_draws(monkeypatch, draws):
    na, ng, nb, nu = (_t(d) for d in draws)
    monkeypatch.setattr(timu, "imu_noise", lambda *a: (na, ng))
    monkeypatch.setattr(tbaro, "pressure_noise", lambda *a: nb)
    monkeypatch.setattr(tuwb, "range_noise", lambda *a: nu)


def _feed_acro_resets(monkeypatch, jstate):
    """The port's acro env restarts in JAX's reset states."""
    t = interop.acro_state_from_numpy(interop.to_numpy_tree(jstate), "cpu")
    monkeypatch.setattr(AcroEnv, "_fresh", lambda self, g, w, b, part=None: t)


def _sensor_pair():
    jenv = JSensor()
    world = jenv.acro.default_world()
    keys = jax.random.split(jax.random.key(0), N)
    js, jobs = jax.vmap(lambda k: jenv.reset(k, world))(keys)
    return jenv, SensorAcroEnv(), world, interop.world_from_numpy(interop.to_numpy_tree(world),
                                                                  "cpu"), keys, js, jobs


def test_sensor_acro_reset_matches_jax(monkeypatch):
    jenv, tenv, jworld, tworld, keys, js, jobs = _sensor_pair()
    k2 = jax.vmap(lambda k: jax.random.split(k, 3)[2])(keys)
    _feed_acro_resets(monkeypatch, js.acro)
    _feed_obs_draws(monkeypatch, _jax_obs_draws(k2))
    ts, tobs = tenv.reset(torch.Generator(), tworld, (N,))
    assert tobs.shape == (N, tenv.obs_dim) == (N, 21) and tobs.dtype == torch.float32
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=0)
    assert np.abs(tobs.numpy() - np.asarray(jobs)).max() < 1e-4
    _close(ts, js, 1e-6)


def test_sensor_acro_step_matches_jax_across_resets(monkeypatch):
    """One step where the first 8 envs reach ``max_episode_steps``: they
    restart in JAX's reset states with their action memory zeroed, the rest
    carry the action; the observation from JAX's draws."""
    jenv, tenv, jworld, tworld, keys, js, _ = _sensor_pair()
    js = js.replace(acro=js.acro.replace(t=js.acro.t.at[:8].set(jenv.acro.max_episode_steps - 1)))
    rng = np.random.default_rng(1)
    act = rng.uniform(-0.3, 0.3, (N, 4)).astype(np.float32)
    act[:, 3] = -0.6
    jn, jobs, jr, jd, _ = jax.vmap(lambda s, a: jenv.step(s, a, jworld))(js, jnp.asarray(act))

    acro = jenv.acro

    def reset_state(k):  # JAX AcroEnv.step's auto-reset draws
        _, kd, kr, kw, knext = jax.random.split(k, 5)
        drone = acro._sample_drone(kd)
        return JAcroState(drone=drone, domain_rand=acro._sample_dr(kr), t=jnp.zeros((), jnp.int32),
                          prev_dist=jnp.linalg.norm(jworld.sphere_center[0] - drone.pos),
                          key=knext, episode_return=jnp.zeros((), jnp.float32),
                          wind=acro._sample_wind(kw))

    _feed_acro_resets(monkeypatch, jax.vmap(reset_state)(js.acro.key))
    ko = jax.vmap(lambda k: jax.random.split(k)[1])(js.key)
    _feed_obs_draws(monkeypatch, _jax_obs_draws(ko))
    ts = interop.sensor_acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    tn, tobs, tr, td, _ = tenv.step(ts, torch.from_numpy(act), tworld, generator=torch.Generator())
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[:8].all() and not td[8:].any()
    assert (tn.prev_action[:8] == 0).all() and torch.equal(tn.prev_action[8:],
                                                           torch.from_numpy(act[8:]))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-4, rtol=0)
    _close(tn, jn, 1e-5)


def test_sensor_acro_own_draws():
    """From its own generator: the shape, finite observations, randomized
    masses, noisy readings that differ between steps."""
    env = SensorAcroEnv()
    g = torch.Generator().manual_seed(1)
    world = env.acro.default_world("cpu")
    st, o1 = env.reset(g, world, (8,))
    a = torch.zeros(8, 4)
    a[:, 3] = -0.6
    st, o2, *_ = env.step(st, a, world, generator=g)
    st, o3, *_ = env.step(st, a, world, generator=g)
    assert o2.shape == (8, 21) and torch.isfinite(o3).all()
    assert st.acro.domain_rand.mass_scale.std() > 0
    assert not torch.allclose(o2, o3)


# ---------------------------------------------------------------------------
# HoverEnv + HoverPilot
# ---------------------------------------------------------------------------


def _hover_draws(keys, env):
    """JAX's reset draws per key: ``_, kp, kt = split(key, 3)``."""
    def one(k):
        _, kp, kt = jax.random.split(k, 3)
        return (jax.random.uniform(kt, (), jnp.float32, *env.spawn_height),
                jax.random.normal(kp, (3,), jnp.float32))

    return jax.vmap(one)(keys)


def test_hover_reset_matches_jax(monkeypatch):
    jenv = JHover()
    keys = jax.random.split(jax.random.key(3), N)
    js, jobs = jax.vmap(jenv.reset)(keys)
    z, n = _hover_draws(keys, jenv)
    monkeypatch.setattr(thover, "reset_draws", lambda *a: (_t(z), _t(n)))
    ts, tobs = HoverEnv().reset(torch.Generator(), (N,), "cpu")
    _close(ts, js, 1e-6)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    assert ts.t.dtype == torch.int32 and ts.t.shape == (N,)
    assert (ts.drone.pos[:, 2] >= 1.0).all()


def test_hover_step_matches_jax_across_resets(monkeypatch):
    """One step where the first 8 envs reach ``max_episode_steps``: every
    env draws a reset (JAX's ``kr``), kept where done."""
    jenv = JHover()
    keys = jax.random.split(jax.random.key(4), N)
    js, _ = jax.vmap(jenv.reset)(keys)
    js = js.replace(t=js.t.at[:8].set(jenv.max_episode_steps - 1))
    act = np.random.default_rng(2).uniform(-0.4, 0.4, (N, 4)).astype(np.float32)
    act[:, 3] = -0.64
    world = jenv.default_world()
    jn, jobs, jr, jd, jinfo = jax.vmap(lambda s, a: jenv.step(s, a, world))(js, jnp.asarray(act))
    kr = jax.vmap(lambda k: jax.random.split(k)[1])(js.key)
    z, n = _hover_draws(kr, jenv)
    monkeypatch.setattr(thover, "reset_draws", lambda *a: (_t(z), _t(n)))
    ts = interop.hover_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    tn, tobs, tr, td, tinfo = HoverEnv().step(ts, torch.from_numpy(act),
                                              generator=torch.Generator())
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td[:8].all() and not td[8:].any()
    _close(tn, jn, 1e-5)
    for a, b in ((tobs, jobs), (tr, jr), (tinfo["pos_err"], jinfo["pos_err"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)


def test_hover_pilot_600_steps_matches_jax():
    """tests/test_envs.py::TestHoverEnv's closed loop, 600 steps, on 8 envs
    from JAX's resets, env 0 that test's own (key 0): no crash, JAX's
    conditions on env 0 (last error < 0.3 x the first, the last 50 below
    2 m) and on the bank's mean (the last 50 below 2 m), and the trajectory
    on JAX's. The pilot settles about 1.01 m off its target in both
    packages, so an env that starts closer than ~3.4 m cannot meet the 0.3
    ratio: JAX's test meets it on its env, which starts 6.37 m off."""
    jenv, jpilot = JHover(), JPilot(drone_params=JP())
    js, _ = jax.vmap(jenv.reset)(jnp.concatenate([jax.random.key(0)[None],
                                                   jax.random.split(jax.random.key(1), 7)]))
    world = jenv.default_world()

    @jax.jit
    def run(st, ps):
        def body(carry, _):
            s, p = carry
            p, a = jax.vmap(jpilot.act)(p, s.drone, s.target_pos)
            s, _, _, d, info = jax.vmap(lambda s_, a_: jenv.step(s_, a_, world))(s, a)
            return (s, p), (info["pos_err"], d)

        return jax.lax.scan(body, (st, ps), None, length=600)

    (jfinal, _), (jerrs, jdones) = run(js, jpilot.init((8,), jnp.float32))
    env, pilot = HoverEnv(), HoverPilot(drone_params=DroneParams())
    ts = interop.hover_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    ps = pilot.init((8,), device="cpu")
    tworld = env.default_world("cpu")
    g = torch.Generator()
    errs, dones = [], []
    for _ in range(600):
        ps, a = pilot.act(ps, ts.drone, ts.target_pos)
        ts, _, _, d, info = env.step(ts, a, tworld, generator=g)
        errs.append(info["pos_err"])
        dones.append(d)
    errs, dones = torch.stack(errs).numpy(), torch.stack(dones).numpy()
    assert not dones.any() and not np.asarray(jdones).any()
    assert errs[-1, 0] < 0.3 * errs[0, 0] and errs[-50:, 0].mean() < 2.0, errs[[0, -1], 0]
    assert errs[-50:].mean() < 2.0 and errs[-1].mean() < errs[0].mean()
    np.testing.assert_allclose(ts.drone.pos.numpy(), np.asarray(jfinal.drone.pos), atol=2e-3)
    np.testing.assert_allclose(errs, np.asarray(jerrs), atol=2e-3)


def test_hover_pilot_keeps_jax_pid_argument_order():
    """JAX calls ``pid_step(alt_pid, state, target_z, z)``: ``current`` is
    the target, so the thrust rises below the target. The same drone below
    and above its target gets more and less throttle, as in JAX."""
    pilot, jpilot = HoverPilot(drone_params=DroneParams()), JPilot(drone_params=JP())
    jenv = JHover()
    js, _ = jax.vmap(jenv.reset)(jax.random.split(jax.random.key(5), 2))
    target = np.array([[0.0, 0.0, 8.0], [0.0, 0.0, 8.0]], np.float32)
    pos = np.array([[0.0, 0.0, 5.0], [0.0, 0.0, 11.0]], np.float32)  # below, above
    jd = js.drone.replace(pos=jnp.asarray(pos))
    _, ja = jax.vmap(jpilot.act)(jpilot.init((2,), jnp.float32), jd, jnp.asarray(target))
    td = interop.drone_state_from_numpy(interop.to_numpy_tree(jd), "cpu")
    _, ta = pilot.act(pilot.init((2,), device="cpu"), td, torch.from_numpy(target))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
    assert ta[0, 3] > ta[1, 3]


def test_hover_reset_clamps_and_is_deterministic():
    env = HoverEnv()
    a = env.reset(torch.Generator().manual_seed(7), (256,), "cpu")[1]
    s, b = env.reset(torch.Generator().manual_seed(7), (256,), "cpu")
    assert torch.equal(a, b) and (s.drone.pos[:, 2] >= 1.0).all()
    assert ((s.target_pos[:, 2] >= 4.0) & (s.target_pos[:, 2] < 12.0)).all()


# ---------------------------------------------------------------------------
# BallEnv + ProportionalNavigation
# ---------------------------------------------------------------------------


def _ball_draws(keys, dtype=jnp.float32):
    """JAX's ``_sample(sub)`` per key: ``kp, kg = split(sub)``."""
    def one(sub):
        kp, kg = jax.random.split(sub)
        return (jax.random.uniform(kp, (2,), dtype, -1.0, 1.0),
                jax.random.uniform(kg, (2,), dtype, -1.0, 1.0))

    return jax.vmap(one)(keys)


def test_ball_reset_and_step_match_jax(monkeypatch):
    jenv = JBall(threshold=0.5)
    keys = jax.random.split(jax.random.key(6), N)
    js, jobs = jax.vmap(jenv.reset)(keys)
    p, g = _ball_draws(jax.vmap(lambda k: jax.random.split(k)[1])(keys))
    monkeypatch.setattr(tball, "reset_draws", lambda *a: (_t(p), _t(g)))
    env = BallEnv(threshold=0.5)
    ts, tobs = env.reset(torch.Generator(), (N,), "cpu")
    _close(ts, js, 0.0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-7)
    act = np.asarray(js.goal - js.pos) * 0.9  # most envs end within the threshold
    act[::3] *= -0.1
    jn, jobs, jr, jd, _ = jax.vmap(jenv.step)(js, jnp.asarray(act))
    p, g = _ball_draws(jax.vmap(lambda k: jax.random.split(k)[1])(js.key))
    monkeypatch.setattr(tball, "reset_draws", lambda *a: (_t(p), _t(g)))
    tn, tobs, tr, td, _ = env.step(ts, torch.from_numpy(act.copy()), torch.Generator())
    assert np.asarray(jd).any() and not np.asarray(jd).all()
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tn, jn, 0.0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=1e-7)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-7)


def test_propnav_act_matches_jax(monkeypatch):
    agent, jagent = ProportionalNavigation(), JPropNav()
    rng = np.random.default_rng(7)
    obs = rng.uniform(0, 2, N).astype(np.float32)
    prev = rng.uniform(0, 2, N).astype(np.float32)
    has = rng.uniform(size=N) < 0.5
    key = jax.random.key(8)
    jst = jagent.init((N,), jnp.float32).replace(prev_obs=jnp.asarray(prev),
                                                 has_prev=jnp.asarray(has))
    jn, ja = jagent.act(jst, jnp.asarray(obs), key)
    draw = jax.random.uniform(key, (N, 2), jnp.float32, -1.0, 1.0)
    monkeypatch.setattr(tball, "random_actions", lambda *a: _t(draw))
    tst = PropNavState(prev_obs=torch.from_numpy(prev), has_prev=torch.from_numpy(has))
    tn, ta = agent.act(tst, torch.from_numpy(obs), torch.Generator())
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert tn.has_prev.all() and torch.equal(tn.prev_obs, torch.from_numpy(obs))


def test_propnav_approaches_diagonal_optimum(monkeypatch):
    """tests/test_envs.py::TestBallEnv on a bank of its 10 keys (their
    resets and first random actions fed in; later steps steer from the
    range alone): the range-only agent gets within 0.2 of the distance from
    the goal to its diagonal line in at least 8 of them."""
    keys = [jax.random.key(i) for i in range(10)]
    p, g = _ball_draws(jnp.stack([jax.random.split(k)[1] for k in keys]), jnp.float64)
    first = jnp.stack([jax.random.uniform(jax.random.split(k)[1], (2,), jnp.float64, -1.0, 1.0)
                       for k in keys])
    monkeypatch.setattr(tball, "reset_draws", lambda *a: (_t(p), _t(g)))
    monkeypatch.setattr(tball, "random_actions", lambda *a: _t(first))
    env = BallEnv(auto_reset=False, dtype=torch.float64)
    agent = ProportionalNavigation()
    gen = torch.Generator()
    state, obs = env.reset(gen, (10,), "cpu")
    d = (state.goal - state.pos).numpy()
    line_dist = np.abs(d[:, 0] - d[:, 1]) / np.sqrt(2.0)
    astate = agent.init((10,), torch.float64, "cpu")
    min_obs, live = obs.clone(), torch.ones(10, dtype=torch.bool)
    for _ in range(400):
        astate, action = agent.act(astate, obs, gen)
        state, obs, _, done, _ = env.step(state, 0.05 * action, gen)
        min_obs = torch.where(live, torch.minimum(min_obs, obs), min_obs)
        live &= ~done  # JAX's loop stops an env at its goal
    assert (min_obs.numpy() <= line_dist + 0.2).sum() >= 8


# ---------------------------------------------------------------------------
# MaComGridEnv
# ---------------------------------------------------------------------------


def _grid_draws(keys, n):
    def one(sub):
        ka, kg = jax.random.split(sub)
        return (jax.random.randint(ka, (2,), 0, n).astype(jnp.int32),
                jax.random.randint(kg, (2,), 0, n).astype(jnp.int32))

    return jax.vmap(one)(keys)


def test_grid_matches_jax_and_wraps_below_zero(monkeypatch):
    """Reset and two steps against JAX, the moves chosen so that agents on
    row or column 0 move -1 and wrap to map_size - 1 (``jnp.mod`` of a
    negative int, ``torch.remainder``); the envs that reach the goal restart
    from JAX's draws."""
    jenv, env = JGrid(map_size=5), MaComGridEnv(map_size=5)
    keys = jax.random.split(jax.random.key(9), N)
    js, jobs = jax.vmap(jenv.reset)(keys)
    a, g = _grid_draws(jax.vmap(lambda k: jax.random.split(k)[1])(keys), 5)
    monkeypatch.setattr(tgrid, "reset_draws", lambda *x: (_t(a), _t(g)))
    ts, tobs = env.reset(torch.Generator(), (N,), "cpu")
    _close(ts, js, 0.0)
    np.testing.assert_array_equal(tobs["Instructor"].numpy(), np.asarray(jobs["Instructor"]))
    wrapped = False
    for i in range(2):
        rc = np.asarray(js.agent_rc)
        move = np.where(rc[:, 0] == 0, 2, np.where(rc[:, 1] == 0, 4, np.arange(N) % 5)).astype(
            np.int32)
        wrapped |= bool(((rc[:, 0] == 0) & (move == 2)).any())
        msg = np.random.default_rng(i).normal(size=(N, 2)).astype(np.float32)
        jn, jobs, jr, jd, _ = jax.vmap(jenv.step)(js, {"Instructor": jnp.asarray(msg),
                                                       "Apprentice": jnp.asarray(move)})
        a, g = _grid_draws(jax.vmap(lambda k: jax.random.split(k)[1])(js.key), 5)
        monkeypatch.setattr(tgrid, "reset_draws", lambda *x: (_t(a), _t(g)))
        ts, tobs, tr, td, _ = env.step(ts, {"Instructor": torch.from_numpy(msg),
                                            "Apprentice": torch.from_numpy(move)},
                                       torch.Generator())
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        _close(ts, jn, 0.0)
        for k in ("Instructor", "Apprentice"):
            np.testing.assert_array_equal(tobs[k].numpy(), np.asarray(jobs[k]))
        js = jn
    assert wrapped and ts.agent_rc.dtype == torch.int32


def test_grid_oracle_policy_reaches_goal():
    env = MaComGridEnv(map_size=5, auto_reset=False)
    state, _ = env.reset(torch.Generator().manual_seed(0), (16,), "cpu")
    for _ in range(20):
        diff = (state.goal_rc - state.agent_rc).numpy() % 5
        mv = np.where(diff[:, 0] != 0, np.where(diff[:, 0] <= 2, 1, 2),
                      np.where(diff[:, 1] != 0, np.where(diff[:, 1] <= 2, 3, 4), 0))
        state, obs, r, done, _ = env.step(state, {"Instructor": torch.zeros(16, 2),
                                                  "Apprentice": torch.from_numpy(mv)})
    assert state.done.all() and obs["Instructor"].shape == (16, 5, 5)


# ---------------------------------------------------------------------------
# Bank layouts
# ---------------------------------------------------------------------------


def _grid_action(n):
    return {"Instructor": torch.ones(n, 2), "Apprentice": torch.arange(n) % 5}


@pytest.mark.parametrize("name", ["sensor_acro", "hover", "ball", "grid"])
def test_a_rank_slice_replays_the_whole_bank(name):
    """Under ``part`` a rank's rows [8, 24) of a 32-env bank draw as one
    process stepping the whole bank: its reset and two steps (with resets)
    equal those rows of the whole bank's."""
    from fpyv_tpu_torch.envs.base import Part

    if name == "sensor_acro":
        env = SensorAcroEnv(acro=AcroEnv(randomize=True, max_episode_steps=2))
        args = (env.acro.default_world("cpu"),)
        act = lambda n: torch.tensor([0.1, -0.1, 0.0, -0.6]).repeat(n, 1)
    elif name == "hover":
        env, args = HoverEnv(max_episode_steps=2), ()
        act = lambda n: torch.tensor([0.0, 0.0, 0.0, -0.64]).repeat(n, 1)
    elif name == "ball":
        env, args = BallEnv(threshold=1.0), ()
        act = lambda n: torch.full((n, 2), 0.05)
    else:
        env, args, act = MaComGridEnv(), (), _grid_action
    whole_act = act(32)
    runs = []
    for shape, part, rows in (((32,), None, slice(None)), ((16,), Part(8, 24, 32), slice(8, 24))):
        g = torch.Generator().manual_seed(3)
        a = ({k: v[rows] for k, v in whole_act.items()} if isinstance(whole_act, dict)
             else whole_act[rows])
        st, obs = env.reset(g, *args, batch_shape=shape, device="cpu", part=part)
        out = [obs]
        for _ in range(2):
            st, obs, r, d, _ = env.step(st, a, *args, generator=g, part=part)
            out += [obs, r, d]
        runs.append(out)
    for whole, rank in zip(*runs):
        if isinstance(whole, dict):
            for k in whole:
                assert torch.equal(whole[k][8:24], rank[k]), k
        else:
            assert torch.equal(whole[8:24], rank)
