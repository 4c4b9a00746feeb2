"""The port's guidance chain against the JAX package on the same inputs:
``pid_step``, ``uwb_range``, ``needed_force_orientation``,
``point_and_shoot`` and ``point_and_shoot_optimize``, and
``GuidanceParams.from_config``.

Inputs are float64 numpy arrays from a seed (the test process runs JAX with
x64 on), so both sides run the same algorithm in float64 and agree to 1e-10;
only the order of a few 3-term sums may differ.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.config import FpyvConfig as JCfg
from fpyv_tpu.control import guidance as jg
from fpyv_tpu.control import pid as jpid
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.sensors.uwb import uwb_range as juwb
from fpyv_tpu.vision.camera import CameraRig as JRig, camera_pose as jpose
from fpyv_tpu_torch.config import FpyvConfig as TCfg
from fpyv_tpu_torch.control import guidance as tg
from fpyv_tpu_torch.control import pid as tpid
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.sensors.uwb import uwb_range as tuwb
from fpyv_tpu_torch.vision.camera import CameraRig as TRig, camera_pose as tpose

N = 32
RIG = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0, resolution=(640, 480))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float64))


def _close(a, b, atol=1e-10):
    np.testing.assert_allclose(a.numpy() if isinstance(a, torch.Tensor) else a,
                               np.asarray(b), atol=atol)


def _params():
    jp, tp = JP.from_config(JCfg()), TP.from_config(TCfg())
    return jp, tp, jg.GuidanceParams.from_config(JCfg(), jp), \
        tg.GuidanceParams.from_config(TCfg(), tp)


def _poses(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
    pos = rng.uniform([-5, -5, 0.3], [5, 5, 8.0], (N, 3))
    vel = rng.normal(size=(N, 3)) * 2.0
    pixel = rng.uniform([0, 0], [640, 480], (N, 2))
    dist = rng.uniform(0.5, 20.0, N)
    return pos, vel, R, pixel, dist


def test_guidance_params_from_config_match():
    _, _, jgp, tgp = _params()
    assert dataclasses_equal(jgp, tgp)


def dataclasses_equal(a, b):
    import dataclasses

    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    fa["pid"], fb["pid"] = dataclasses.asdict(fa["pid"]), dataclasses.asdict(fb["pid"])
    return fa == fb


def test_pid_sequence_matches_jax():
    p = dict(kP=0.3, kI=1.5, kD=0.2, dt=1 / 60, integral_clip=2.0, min_output=-3.0,
             max_output=3.0, derivative_transition_rate=0.3)
    jp_, tp_ = jpid.PidParams(**p), tpid.PidParams(**p)
    js, ts = jpid.pid_init((N,), jnp.float64), tpid.pid_init((N,), torch.float64, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(40):
        cur, tgt = rng.normal(size=N) * 4, rng.normal(size=N)
        js, jo = jpid.pid_step(jp_, js, jnp.asarray(cur), jnp.asarray(tgt))
        ts, to = tpid.pid_step(tp_, ts, _t(cur), _t(tgt))
        _close(to, jo)
    for k in ("integral", "prev_derivative", "previous_error"):
        _close(getattr(ts, k), getattr(js, k))


def test_uwb_range_matches_jax():
    rng = np.random.default_rng(2)
    pos, tgt = rng.normal(size=(N, 3)) * 10, rng.normal(size=(N, 3)) * 10
    r = rng.uniform(0.5, 2.0, N)
    _close(tuwb(_t(pos), _t(tgt), _t(r)), juwb(jnp.asarray(pos), jnp.asarray(tgt),
                                                 jnp.asarray(r)))
    _close(tuwb(_t(pos), _t(tgt), 1.0, max_range=5.0),
           juwb(jnp.asarray(pos), jnp.asarray(tgt), 1.0, max_range=5.0))


def test_camera_pose_matches_jax():
    pos, _, R, _, _ = _poses(3)
    jp_, jR = jpose(JRig(**RIG), jnp.asarray(pos), jnp.asarray(R))
    tp_, tR = tpose(TRig(**RIG), _t(pos), _t(R))
    _close(tp_, jp_)
    _close(tR, jR)


@pytest.mark.parametrize("mode", ["level", "frontarget"])
def test_needed_force_orientation_sequence_matches_jax(mode):
    jp, tp, jgp, tgp = _params()
    jgp = jgp.__class__(**{**jgp.__dict__, "mode": mode})
    tgp = tgp.__class__(**{**tgp.__dict__, "mode": mode})
    js, ts = jg.guidance_init((N,), jnp.float64), tg.guidance_init((N,), torch.float64, "cpu")
    for step in range(6):  # the PID memory carries across calls
        pos, vel, R, pixel, dist = _poses(10 + step)
        _, jcR = jpose(JRig(**RIG), jnp.asarray(pos), jnp.asarray(R))
        _, tcR = tpose(TRig(**RIG), _t(pos), _t(R))
        js, jR, jf = jg.needed_force_orientation(jgp, js, JRig(**RIG), jcR, jnp.asarray(pixel),
                                                 jnp.asarray(pos), jnp.asarray(vel),
                                                 jnp.asarray(dist), jp.mass)
        ts, tR, tf = tg.needed_force_orientation(tgp, ts, TRig(**RIG), tcR, _t(pixel), _t(pos),
                                                 _t(vel), _t(dist), tp.mass)
        _close(tR, jR)
        _close(tf, jf)
    _close(ts.pid.integral, js.pid.integral)


def test_point_and_shoot_sequence_matches_jax():
    jp, tp, jgp, tgp = _params()
    js, ts = jg.guidance_init((N,), jnp.float64), tg.guidance_init((N,), torch.float64, "cpu")
    maxf = float(jp.thrust_curve.max_force)
    for step in range(6):
        pos, vel, R, pixel, _ = _poses(20 + step)
        act = np.random.default_rng(step).uniform(-1, 1, (N, 4))
        _, jcR = jpose(JRig(**RIG), jnp.asarray(pos), jnp.asarray(R))
        _, tcR = tpose(TRig(**RIG), _t(pos), _t(R))
        js, jR, jf = jg.point_and_shoot(jgp, js, JRig(**RIG), jcR, jnp.asarray(pixel),
                                        jnp.asarray(act), jnp.asarray(pos), jnp.asarray(vel),
                                        jp.mass, maxf, jp.dt)
        ts, tR, tf = tg.point_and_shoot(tgp, ts, TRig(**RIG), tcR, _t(pixel), _t(act),
                                        _t(pos), _t(vel), tp.mass, maxf, tp.dt)
        _close(tR, jR)
        _close(tf, jf)
    _close(ts.pixel_velocity, js.pixel_velocity)


def test_point_and_shoot_optimize_matches_jax():
    jp, tp, jgp, tgp = _params()
    pos, vel, R, pixel, _ = _poses(30)
    maxf = float(jp.thrust_curve.max_force)
    _, jcR = jpose(JRig(**RIG), jnp.asarray(pos), jnp.asarray(R))
    _, tcR = tpose(TRig(**RIG), _t(pos), _t(R))
    jR, jf, jrow = jg.point_and_shoot_optimize(jgp, JRig(**RIG), jcR, jnp.asarray(pixel),
                                               jnp.asarray(pos), jnp.asarray(vel), jp.mass,
                                               maxf)
    tR, tf, trow = tg.point_and_shoot_optimize(tgp, TRig(**RIG), tcR, _t(pixel), _t(pos),
                                               _t(vel), tp.mass, maxf)
    _close(tR, jR, atol=1e-8)
    _close(tf, jf, atol=1e-8)
    _close(trow, jrow, atol=1e-6)
