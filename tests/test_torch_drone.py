"""The port's drone step against the JAX package (float32) and the float64
NumPy oracle ``tools/oracle/sim.py``.

Tolerances: one float32 step from the same inputs agrees to atol 1e-5 in
position/velocity and 1e-6 in attitude, rates/thrust 1e-4 (as
tests/test_pallas_step.py:53-63); with ground contact the spring
(k = 100) scales a distance ulp into velocity, so velocity gets 1e-4 there
(tests/test_pallas_step.py:72). Against the float64 oracle the port runs in
float64 and matches to 1e-9 over 300 steps, as tests/test_drone_parity.py
holds the JAX package.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.config import FpyvConfig as JCfg
from fpyv_tpu.ops import rotations as jrot
from fpyv_tpu.physics import drone as jd
from fpyv_tpu.physics.world import empty_world as jempty
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.config import FpyvConfig as TCfg
from fpyv_tpu_torch.physics import drone as td
from fpyv_tpu_torch.physics.world import empty_world as tempty
from tools.oracle.sim import OracleCylinder, OracleDrone, OracleGround, OracleTarget


def _world_pair():
    w = jempty(n_spheres=2, n_cylinders=1, ground=True, dtype=jnp.float32)
    w = w.replace(
        sphere_center=jnp.asarray([[3.0, 0.0, 5.0], [-4.0, 2.0, 8.0]], jnp.float32),
        sphere_radius=jnp.asarray([1.0, 1.5], jnp.float32),
        cyl_center=jnp.asarray([[1.0, -2.0, 0.0]], jnp.float32),
        cyl_radius=jnp.asarray([1.0], jnp.float32),
        cyl_height=jnp.asarray([8.0], jnp.float32),
    )
    return w, interop.world_from_numpy(interop.to_numpy_tree(w), "cpu")


def _inputs(seed, n=128, z=8.0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        pos=(rng.uniform(-3, 3, (n, 3)) + [0, 0, z]).astype(f),
        vel=rng.uniform(-2, 2, (n, 3)).astype(f),
        ypr=rng.uniform(-40, 40, (n, 3)).astype(f),
        action=rng.uniform(-0.5, 0.5, (n, 4)).astype(f),
        wind=rng.uniform(-3, 3, (n, 3)).astype(f),
        dr=[rng.uniform(lo, hi, n).astype(f) for lo, hi in ((0.8, 1.2), (0.7, 1.3),
                                                            (0.85, 1.15))],
        override_ypr=rng.uniform(-0.5, 0.5, (n, 3)).astype(f),
        override_thrust=rng.uniform(3, 12, n).astype(f),
    )


def _step_both(att_mode, quirk, extra, seed=0, z=8.0, steps=1, n_motors=4):
    jp = jd.DroneParams(att_mode=att_mode, double_rotation_quirk=quirk, n_motors=n_motors)
    tp = td.DroneParams(att_mode=att_mode, double_rotation_quirk=quirk, n_motors=n_motors)
    jworld, tworld = _world_pair()
    x = _inputs(seed, z=z)
    js = jd.drone_reset(jp, *(jnp.asarray(x[k]) for k in ("pos", "vel", "ypr")))
    ts = td.drone_reset(tp, *(torch.from_numpy(x[k]) for k in ("pos", "vel", "ypr")))
    jkw, tkw = {}, {}
    if extra == "dr_wind":
        jkw = dict(wind=jnp.asarray(x["wind"]),
                   domain_rand=jd.DomainRand(*map(jnp.asarray, x["dr"])))
        tkw = dict(wind=torch.from_numpy(x["wind"]),
                   domain_rand=td.DomainRand(*map(torch.from_numpy, x["dr"])))
    elif extra == "override":
        R = np.array(jrot.euler_to_rotmat(jnp.asarray(x["override_ypr"])))
        jkw = dict(att_override=jnp.asarray(R), thrust_override=jnp.asarray(x["override_thrust"]))
        tkw = dict(att_override=torch.from_numpy(R),
                   thrust_override=torch.from_numpy(x["override_thrust"]))
    for _ in range(steps):
        js, jobs = jd.drone_step(jp, js, jnp.asarray(x["action"]), jworld, **jkw)
        ts, tobs = td.drone_step(tp, ts, torch.from_numpy(x["action"]), tworld, **tkw)
    return interop.to_numpy_tree(ts), interop.to_numpy_tree(js), tobs, jobs


@pytest.mark.parametrize("extra", ["plain", "dr_wind", "override"])
@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("att_mode", ["quat", "rotmat"])
def test_drone_step_matches_jax_f32(att_mode, quirk, extra):
    a, b, tobs, jobs = _step_both(att_mode, quirk, extra)
    for k in ("pos", "vel", "att", "rates", "thrust", "accel", "done"):
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-5)
    np.testing.assert_allclose(a["att"], b["att"], atol=1e-6)
    np.testing.assert_allclose(a["rates"], b["rates"], atol=1e-4)
    np.testing.assert_allclose(a["thrust"], b["thrust"], atol=1e-4)
    np.testing.assert_allclose(a["accel"], b["accel"], atol=1e-3)  # 60x the velocity step
    np.testing.assert_array_equal(a["done"], b["done"])
    for k in ("world_from_body_T", "gyro_matrix"):
        np.testing.assert_allclose(getattr(tobs, k).numpy(), np.asarray(getattr(jobs, k)),
                                   atol=1e-6)
    np.testing.assert_allclose(tobs.accel_body.numpy(), np.asarray(jobs.accel_body), atol=1e-3)


@pytest.mark.parametrize("att_mode", ["quat", "rotmat"])
def test_ground_contact_and_crash_flags(att_mode):
    a, b, _, _ = _step_both(att_mode, True, "plain", seed=3, z=0.1)
    assert b["done"].any() and not b["done"].all()  # premise: contacts and crashes
    np.testing.assert_array_equal(a["done"], b["done"])
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-4)
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)


@pytest.mark.parametrize("att_mode", ["quat", "rotmat"])
def test_hexacopter_step_matches_jax_f32(att_mode):
    """Six motor points (DroneParams.n_motors = 6) near the ground: the
    contact sums and crash flags over the hexacopter's points."""
    a, b, _, _ = _step_both(att_mode, True, "plain", seed=3, z=0.1, n_motors=6)
    assert b["done"].any() and not b["done"].all()  # premise: contacts and crashes
    np.testing.assert_array_equal(a["done"], b["done"])
    np.testing.assert_allclose(a["vel"], b["vel"], atol=1e-4)
    np.testing.assert_allclose(a["pos"], b["pos"], atol=1e-5)
    np.testing.assert_allclose(a["att"], b["att"], atol=1e-6)


def test_multi_step_quat_trajectory():
    a, b, _, _ = _step_both("quat", True, "dr_wind", seed=5, z=15.0, steps=20)
    # 20 chained float32 steps: the tolerance of tests/test_pallas_step.py's rollouts
    np.testing.assert_allclose(a["pos"], b["pos"], atol=2e-4)
    np.testing.assert_allclose(a["att"], b["att"], atol=1e-4)


def test_drone_reset_and_params_match_jax():
    x = _inputs(7)
    for mode in ("quat", "rotmat"):
        js = jd.drone_reset(jd.DroneParams(att_mode=mode),
                            *(jnp.asarray(x[k]) for k in ("pos", "vel", "ypr")))
        ts = td.drone_reset(td.DroneParams(att_mode=mode),
                            *(torch.from_numpy(x[k]) for k in ("pos", "vel", "ypr")))
        a, b = interop.to_numpy_tree(ts), interop.to_numpy_tree(js)
        for k in a:
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, err_msg=k)
    jp, tp = jd.DroneParams.from_config(JCfg()), td.DroneParams.from_config(TCfg())
    for f in ("dt", "gravity", "mass", "max_rates", "drag_coef", "cross_sections",
              "rates_transition_rate", "thrust_transition_rate", "motor_radius"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.motors_relative_position, jp.motors_relative_position)
    assert tp.thrust_curve.throttle2thrust_coeffs == jp.thrust_curve.throttle2thrust_coeffs


# ---------------------------------------------------------------------------
# float64 oracle (tools/oracle/sim.py), as tests/test_drone_parity.py
# ---------------------------------------------------------------------------


def _oracle_world(seed, n_targets, n_cyl):
    rng = np.random.default_rng(seed)
    t_pos = rng.uniform(-3, 3, (n_targets, 3)) + np.array([0, 0, 5.0])
    t_rad = rng.uniform(0.5, 1.5, n_targets)
    c_pos = rng.uniform(-8, 8, (n_cyl, 3)) * np.array([1, 1, 0])
    c_rad = rng.uniform(1, 2.5, n_cyl)
    c_h = rng.uniform(5, 12, n_cyl)
    objs = [OracleTarget(t_pos[i], t_rad[i]) for i in range(n_targets)]
    objs += [OracleCylinder(c_pos[i], c_rad[i], c_h[i]) for i in range(n_cyl)]
    objs += [OracleGround()]
    w = tempty(n_spheres=n_targets, n_cylinders=n_cyl, ground=True, dtype=torch.float64,
               device="cpu")
    w = w.replace(sphere_center=torch.from_numpy(t_pos), sphere_radius=torch.from_numpy(t_rad),
                  sphere_path_center=torch.from_numpy(t_pos),
                  cyl_center=torch.from_numpy(c_pos), cyl_radius=torch.from_numpy(c_rad),
                  cyl_height=torch.from_numpy(c_h))
    return objs, w


@pytest.mark.parametrize("att_mode", ["rotmat", "quat"])
def test_free_flight_matches_float64_oracle(att_mode):
    cfg = JCfg()
    rng = np.random.default_rng(42)
    T = 300
    acts = rng.uniform(-1, 1, (T, 4)) * np.array([0.3, 0.3, 0.2, 1.0])
    acts[:, 3] = rng.uniform(-0.6, 0.3, T)
    wind = np.array([0.5, -0.3, 0.1])
    objs, world = _oracle_world(0, 1, 2)

    oracle = OracleDrone(cfg)
    oracle.reset(cfg.drone.initial_position, cfg.drone.initial_velocity,
                 cfg.drone.initial_orientation)
    params = td.DroneParams.from_config(TCfg(), att_mode=att_mode)
    f64 = dict(dtype=torch.float64)
    st = td.drone_reset(params, torch.tensor(cfg.drone.initial_position, **f64),
                        torch.tensor(cfg.drone.initial_velocity, **f64),
                        torch.tensor(cfg.drone.initial_orientation, **f64))
    from fpyv_tpu_torch.ops import rotations as trot

    for t in range(T):
        oracle.step(acts[t], wind, objs)
        st, _ = td.drone_step(params, st, torch.from_numpy(acts[t]), world,
                              wind=torch.from_numpy(wind))
        if t in (0, 1, 10, 100, 299):
            R = st.att if att_mode == "rotmat" else trot.quat_to_rotmat(st.att)
            np.testing.assert_allclose(st.pos.numpy(), oracle.pos, atol=1e-9)
            np.testing.assert_allclose(R.numpy(), oracle.R, atol=1e-9)
            np.testing.assert_allclose(st.vel.numpy(), oracle.vel, atol=1e-9)
            np.testing.assert_allclose(float(st.thrust), oracle.prev_thrust, atol=1e-9)
        assert bool(st.done) == bool(oracle.done)
