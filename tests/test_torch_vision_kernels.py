"""The port's vision kernels K5 (raycast render) and K6 (chase megaloop):
their plain PyTorch versions against the JAX Pallas kernels run with
``interpret=True`` on the CPU, and the chase as a whole against one composed
from the port's own renderer, guidance law and drone step. The CUDA kernels
against their plain versions on the card are in tests/test_torch_cuda.py.

Tolerances:
- K5 levels are equal: the render is elementwise float32 arithmetic in the
  same order on both sides, quantised to 256 levels.
- K6 (tests/test_pallas_vision.py:287-294): after K chained steps pos 1e-4,
  velocity 1e-3, attitude 1e-3 up to sign, reward sums 2e-3; t, done, every
  reset decision and the crash and contact counts equal. The mask centroid
  is exact (sums of half-integers below 2^22); the rest is float32 steps
  whose sin/cos/sqrt differ by ulps between the two libraries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.config import SimulatorConfig as JSim
from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.ops import pallas_vision as jpv
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.physics.world import empty_world as jempty
from fpyv_tpu.vision.camera import CameraRig as JRig
from fpyv_tpu.world.generators import WorldSpec as JSpec, build_world as jbuild
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.control.guidance import GuidanceParams, guidance_init, needed_force_orientation
from fpyv_tpu_torch.control.pid import PidParams
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import vision_kernel as tvk
from fpyv_tpu_torch.physics.drone import DroneParams as TP, _att_to_rotmat, drone_step
from fpyv_tpu_torch.vision.camera import CameraRig as TRig, camera_pose
from fpyv_tpu_torch.vision.raycast import raycast_depth

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(32, 24))
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)


def _tw(jworld):
    return interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")


def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2).astype(np.float32)


def _cams(n, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n, 3)) * 2 + np.array([0, 0, 3.0])).astype(np.float32)
    return pos, _rotations(n, seed + 1)


def _full_world(seed):
    """2 spheres, 3 cylinders (one inactive), one gate of each shape code."""
    rng = np.random.default_rng(seed)
    f = np.float32
    w = jempty(n_spheres=2, n_cylinders=3, n_gates=3, ground=True)
    return w.replace(
        sphere_center=jnp.asarray(rng.normal(size=(2, 3)) * 3 + [0, 0, 4.0], f),
        sphere_radius=jnp.asarray([1.0, 0.7], f),
        cyl_center=jnp.asarray(rng.normal(size=(3, 3)) * 4, f),
        cyl_radius=jnp.asarray([0.5, 0.8, 0.3], f),
        cyl_height=jnp.asarray([5.0, 3.0, 8.0], f),
        cyl_active=jnp.asarray([True, True, False]),
        gate_pos=jnp.asarray(rng.normal(size=(3, 3)) * 2 + [0, 0, 2.0], f),
        gate_rotmat=jnp.asarray(_rotations(3, seed + 7)),
        gate_size=jnp.asarray([2.0, 1.5, 1.8], f),
        gate_shape=jnp.asarray([0, 1, 2], jnp.int32),
    )


def _render_both(jworld, pos, R, **kw):
    ref = np.asarray(jpv.pallas_render_depth(JRIG, jnp.asarray(pos), jnp.asarray(R), jworld,
                                             interpret=True, **kw))
    before = dict(_build.launch_counts)
    out = tvk.fused_render_depth(TRIG, torch.from_numpy(pos), torch.from_numpy(R), _tw(jworld),
                                 **kw).numpy()
    assert _build.launch_counts == before  # the CPU path launches no kernel
    return out, ref


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("include", [("spheres",), ("cylinders",), ("gates",),
                                     ("spheres", "cylinders", "ground", "gates")])
def test_k5_plain_matches_pallas_levels(include):
    pos, R = _cams(16, 1)
    out, ref = _render_both(_full_world(0), pos, R, max_depth=10.0, include=include)
    assert out.shape == ref.shape == (16, 24, 32)
    assert (ref > 0).mean() > 0.01  # premise: the primitives are in view
    np.testing.assert_array_equal(out, ref)


def test_k5_every_gate_shape_hits():
    """Each gate shape code renders somewhere, and the levels stay equal."""
    jworld = _full_world(0)
    rng = np.random.default_rng(3)
    gpos = np.asarray(jworld.gate_pos)
    normals = np.asarray(jworld.gate_rotmat)[:, :, 0]
    pos = np.concatenate([gpos[g] + 4.0 * normals[g] + rng.normal(size=(16, 3)) * 0.2
                          for g in range(3)]).astype(np.float32)
    look = np.repeat(-normals, 16, axis=0)  # camera z (forward) toward the gate
    up = np.cross(look, np.array([0.0, 0.0, 1.0]))
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    R = np.stack([up, np.cross(look, up), look], axis=-1).astype(np.float32)
    for g in range(3):
        only = jworld.replace(gate_active=jnp.asarray(np.arange(3) == g))
        out, ref = _render_both(only, pos[16 * g:16 * (g + 1)], R[16 * g:16 * (g + 1)],
                                max_depth=10.0, include=("gates",))
        assert (ref > 0).any(), f"gate shape {g} never hit"
        np.testing.assert_array_equal(out, ref)


def test_k5_batched_worlds_match_pallas():
    n = 16
    jw = _full_world(2)
    jwb = jax.tree.map(lambda x: jnp.broadcast_to(x, (n,) + x.shape), jw)
    jwb = jwb.replace(sphere_radius=jnp.linspace(0.3, 2.0, n)[:, None] * jnp.ones((1, 2)),
                      has_ground=jnp.arange(n) % 2 == 0)
    pos, R = _cams(n, 5)
    out, ref = _render_both(jwb, pos, R, max_depth=10.0)
    np.testing.assert_array_equal(out, ref)


def test_k5_ground_extent_and_single_camera():
    jw = jempty(ground=True)
    R = np.asarray([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)
    for x, lit in ((100.0, False), (10.0, True)):
        pos = np.asarray([x, 0.0, 3.0], np.float32)
        out, ref = _render_both(jw, pos, R, max_depth=10.0, include=("ground",),
                                ground_extent=50.0)
        assert out.shape == (24, 32)
        assert bool(out.max() > 0) == lit
        np.testing.assert_array_equal(out, ref)


def test_k5_world_cols_match_pallas_layout():
    jw = _full_world(4)
    cfg = jpv._RenderCfg(hw=768, width=32, n_spheres=2, n_cylinders=3, n_gates=3, spheres=True,
                         cylinders=True, ground=True, gates=True, max_depth=10.0,
                         ground_extent=None)
    ref = np.asarray(jpv._world_cols(cfg, jw, 1))
    out = tvk.world_cols(_tw(jw)).numpy()
    assert out.shape == (1, tvk.RenderConfig.for_world(_tw(jw), 10.0).n_cols)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(tvk.flat_dcam(TRIG), jpv._flat_dcam(JRIG))


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _chase_pair(world="default", n=8, seed=0, n_motors=4, **kw):
    jenv = JEnv(params=JP(att_mode="quat", n_motors=n_motors), dtype=jnp.float32, **kw)
    tenv = TEnv(params=TP(att_mode="quat", n_motors=n_motors), **kw)
    jworld = (jenv.default_world() if world == "default"
              else jbuild(JSpec.from_config(JSim(), seed=2), dtype=jnp.float32))
    keys = jax.random.split(jax.random.key(seed), n)
    js, _ = jax.vmap(lambda k: jenv.reset(k, jworld))(keys)
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    return jenv, tenv, jworld, _tw(jworld), js, ts


def _compare_chase(out, ref):
    a, b = interop.chase_to_numpy(out), interop.chase_to_numpy(ref)
    sa, sb = a["state"], b["state"]
    np.testing.assert_array_equal(sa["t"], sb["t"])  # every reset decision
    np.testing.assert_array_equal(sa["drone"]["done"], sb["drone"]["done"])
    np.testing.assert_array_equal(a["crashes"], b["crashes"])
    np.testing.assert_array_equal(a["contacts"], b["contacts"])
    np.testing.assert_array_equal(a["world"]["sphere_path_count"], b["world"]["sphere_path_count"])
    np.testing.assert_allclose(sa["drone"]["pos"], sb["drone"]["pos"], atol=1e-4)
    np.testing.assert_allclose(sa["drone"]["vel"], sb["drone"]["vel"], atol=1e-3)
    qa, qb = sa["drone"]["att"], sb["drone"]["att"]
    qerr = np.minimum(np.abs(qa - qb).max(-1), np.abs(qa + qb).max(-1))
    assert qerr.max() < 1e-3
    np.testing.assert_allclose(a["reward_sum"], b["reward_sum"], atol=2e-3)
    return a


def test_k6_plain_matches_pallas_across_resets():
    jenv, tenv, jworld, tworld, js, ts = _chase_pair(max_episode_steps=5)
    K = 12
    ref = jpv.pallas_vision_env_rollout(jenv, js, jworld, K, rig=JRIG, seed=3, interpret=True)
    before = dict(_build.launch_counts)
    out = tvk.fused_vision_env_rollout(tenv, ts, tworld, K, rig=TRIG, seed=3)
    assert _build.launch_counts == before
    a = _compare_chase(out, ref)
    assert (a["state"]["t"] < K).all()  # premise: every env reset
    assert a["state"]["t"].max() < 5
    b = interop.chase_to_numpy(ref)  # the JAX result into the port and back
    back = interop.chase_to_numpy(interop.chase_from_numpy(b, "cpu"))
    for k in ("reward_sum", "crashes", "contacts"):
        np.testing.assert_array_equal(back[k], b[k])
    np.testing.assert_array_equal(back["state"]["drone"]["pos"], b["state"]["drone"]["pos"])
    np.testing.assert_array_equal(back["world"]["sphere_path_count"],
                                  b["world"]["sphere_path_count"])


def test_k6_params_world_with_dr_wind_and_crashes():
    """The params.yaml world (cylinders) with DomainRand and gusts; drones
    start low so the ground and the obstacles make crash-driven resets."""
    kw = dict(max_episode_steps=6, randomize=True, wind=(1.0, 0.5, 0.0), wind_scale=0.5,
              pos_low=(-12.0, -12.0, 0.2), pos_high=(12.0, 12.0, 1.5))
    jenv, tenv, jworld, tworld, js, ts = _chase_pair("params", seed=4, **kw)
    K = 10
    ref = jpv.pallas_vision_env_rollout(jenv, js, jworld, K, rig=JRIG, seed=6, interpret=True)
    out = tvk.fused_vision_env_rollout(tenv, ts, tworld, K, rig=TRIG, seed=6)
    a = _compare_chase(out, ref)
    assert (a["state"]["t"] < K).all()


def _intercept(n_motors):
    """keep_distance 0 on a static target: the pilot flies into it, so the
    contact counter runs on both sides."""
    jenv, tenv, jworld, tworld, js, ts = _chase_pair(max_episode_steps=1000, n_motors=n_motors)
    center = np.asarray([[0.0, 0.0, 8.0]], np.float32)
    jworld = jworld.replace(sphere_has_path=jnp.zeros((1,), bool),
                            sphere_center=jnp.asarray(center))
    tworld = _tw(jworld)
    rng = np.random.default_rng(8)
    pos = (center + [-1.7, 0.0, 0.0] + rng.normal(size=(8, 3)) * 0.1).astype(np.float32)
    vel = np.tile(np.float32([3.0, 0.0, 0.0]), (8, 1))  # toward the target
    att = np.tile(np.float32([1.0, 0.0, 0.0, 0.0]), (8, 1))  # level, facing +x
    dist = np.linalg.norm(pos - center, axis=-1).astype(np.float32)
    js = js.replace(drone=js.drone.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                                           att=jnp.asarray(att)), prev_dist=jnp.asarray(dist))
    ts = ts.replace(drone=ts.drone.replace(pos=torch.from_numpy(pos), vel=torch.from_numpy(vel),
                                           att=torch.from_numpy(att)),
                    prev_dist=torch.from_numpy(dist))
    pilot = dict(keep_distance=0.0)
    K = 12
    ref = jpv.pallas_vision_env_rollout(jenv, js, jworld, K, rig=JRIG,
                                        pilot=jpv.ChasePilot(**pilot), interpret=True)
    out = tvk.fused_vision_env_rollout(tenv, ts, tworld, K, rig=TRIG,
                                       pilot=tvk.ChasePilot(**pilot))
    a = _compare_chase(out, ref)
    assert a["contacts"].sum() > 0


def test_k6_intercept_contacts_match_pallas():
    _intercept(4)


def test_k6_hexacopter_matches_pallas():
    """The chase with six motor points (DroneParams.n_motors = 6): the
    intercept's contacts, then across resets."""
    _intercept(6)
    jenv, tenv, jworld, tworld, js, ts = _chase_pair(max_episode_steps=5, n_motors=6)
    K = 12
    ref = jpv.pallas_vision_env_rollout(jenv, js, jworld, K, rig=JRIG, seed=3, interpret=True)
    out = tvk.fused_vision_env_rollout(tenv, ts, tworld, K, rig=TRIG, seed=3)
    a = _compare_chase(out, ref)
    assert (a["state"]["t"] < K).all()  # premise: every env reset


def test_quat_cols_from_R_matches_pallas():
    rng = np.random.default_rng(2)
    m = _rotations(256, 9)
    m[:64] = -m[:64]  # improper and near-degenerate inputs take every branch
    m[64:72] = np.diag([1.0, -1.0, -1.0]).astype(np.float32) + rng.normal(size=(8, 3, 3)) * 1e-4
    cols = [m[:, i // 3, i % 3] for i in range(9)]
    ref = jpv._quat_cols_from_R([jnp.asarray(c) for c in cols])
    out = tvk.quat_cols_from_R([torch.from_numpy(c) for c in cols])
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-6)


def test_chase_pilot_fields_match_pallas():
    names = [f.name for f in tvk.dataclasses.fields(tvk.ChasePilot)]
    assert names == list(jpv.ChasePilot._fields)
    assert tvk.ChasePilot() == tvk.ChasePilot(**jpv.ChasePilot()._asdict())
    consts = tvk.chase_constants(TRIG, tvk.ChasePilot(), TP(att_mode="quat"))
    assert consts.as_array().size == 39  # ChaseConsts: 34 pilot floats + K's 5 for the pixel box


# ---------------------------------------------------------------------------
# The slice as a whole: K6's plain version against a chase composed from the
# port's own raycast, guidance law and drone step (tests/test_pallas_vision.py
# _HostChase), before any reset
# ---------------------------------------------------------------------------


def _composed_chase(env, rig, pilot, world, drone, n_steps):
    params = env.params
    curve = params.thrust_curve
    g = GuidanceParams(
        virtual_drag_coef=pilot.virtual_drag_coef, virtual_lift_coef=pilot.virtual_lift_coef,
        tof_effective_distance=pilot.tof_effective_distance,
        keep_distance=pilot.keep_distance, uwb_max_range=pilot.uwb_max_range,
        pid=PidParams(kP=pilot.kP, kI=pilot.kI, kD=pilot.kD, dt=params.dt,
                      integral_clip=pilot.integral_clip, min_output=float(curve.min_force),
                      max_output=float(curve.max_force),
                      derivative_transition_rate=pilot.derivative_transition_rate))
    n = drone.pos.shape[0]
    W, H = rig.resolution
    gs = guidance_init((n,), device="cpu")
    count0 = float(world.sphere_path_count[0])
    scan_w = np.deg2rad(pilot.scan_rate_dps) * params.dt
    scan_s = pilot.scan_tilt * 9.81 * params.mass
    uu, vv = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
    pc = world.sphere_path_center[0].numpy().astype(np.float64)
    pr = float(world.sphere_path_radius[0])
    res = max(float(world.sphere_path_res[0]), 1.0)
    for i in range(n_steps):
        th = 2 * np.pi * ((count0 + i) % res) / res
        c = np.array([pc[0] + pr * np.cos(th), pc[1] + pr * np.sin(th), pc[2]])
        wi = world.replace(sphere_center=torch.tensor(c[None], dtype=torch.float32))
        cam_pos, cam_R = camera_pose(rig, drone.pos, _att_to_rotmat(params, drone.att))
        mask = raycast_depth(rig, cam_pos, cam_R, wi, include=("spheres",)).numpy() < 1e30
        cnt = mask.reshape(n, -1).sum(1)
        ucen = (mask * uu).reshape(n, -1).sum(1) / np.maximum(cnt, 1)
        vcen = (mask * vv).reshape(n, -1).sum(1) / np.maximum(cnt, 1)
        vis = torch.from_numpy(cnt > 0)
        dist = torch.linalg.vector_norm(drone.pos - wi.sphere_center[0], dim=-1) \
            - world.sphere_radius[0]
        gs2, R_des, fnorm = needed_force_orientation(
            g, gs, rig, cam_R, torch.from_numpy(np.stack([ucen, vcen], -1).astype(np.float32)),
            drone.pos, drone.vel, dist, params.mass)
        Fs = np.array([scan_s * np.cos(scan_w * i), scan_s * np.sin(scan_w * i),
                       9.81 * params.mass])
        y = np.cross(Fs, [0.0, 0.0, -9.81 * params.mass])
        x = np.cross(y, Fs)
        Rs = np.stack([x / np.linalg.norm(x), y / np.linalg.norm(y), Fs / np.linalg.norm(Fs)],
                      axis=-1)
        R_use = torch.where(vis[:, None, None], R_des, torch.tensor(Rs, dtype=torch.float32))
        f_use = torch.where(vis, fnorm, torch.tensor(float(np.linalg.norm(Fs))))
        gs = gs.replace(pid=type(gs.pid)(**{
            k: torch.where(vis, getattr(gs2.pid, k), getattr(gs.pid, k))
            for k in ("error", "integral", "prev_derivative", "previous_error", "is_first")}))
        drone, _ = drone_step(params, drone, torch.zeros(n, 4), wi, att_override=R_use,
                              thrust_override=f_use)
    return drone


def test_chase_plain_matches_composed_pilot():
    tenv = TEnv(params=TP(att_mode="quat"))
    tworld = tenv.default_world("cpu")
    rig = TRig(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
               resolution=(64, 48))
    ts, _ = tenv.reset(torch.Generator().manual_seed(0), tworld, (8,))
    pilot = tvk.ChasePilot()
    K = 15
    out, _, _, _, _ = tvk.fused_vision_env_rollout(tenv, ts, tworld, K, rig=rig, pilot=pilot)
    drone = _composed_chase(tenv, rig, pilot, tworld, ts.drone, K)
    assert not out.drone.done.any() and (out.t == K).all()  # no reset in the window
    np.testing.assert_allclose(out.drone.pos.numpy(), drone.pos.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.drone.vel.numpy(), drone.vel.numpy(), atol=1e-3)
    qk, qh = out.drone.att.numpy(), drone.att.numpy()
    assert np.minimum(np.abs(qk - qh).max(-1), np.abs(qk + qh).max(-1)).max() < 1e-3


def test_chase_launch_refuses_cpu_tensors():
    tenv = TEnv(params=TP(att_mode="quat"))
    world = tenv.default_world("cpu")
    from fpyv_tpu_torch.ops.env_kernel import env_world_matrix

    with pytest.raises(ValueError, match="CUDA"):
        tvk.launch_vision_env_rollout(tenv, torch.zeros(tvk.CH_ROWS, 8),
                                      env_world_matrix(world), 4, TRIG)
    cfg = tvk.RenderConfig.for_world(world, 10.0)
    with pytest.raises(ValueError, match="CUDA"):
        tvk.launch_render_depth(cfg, torch.zeros(3, 768), torch.zeros(2, 16),
                                tvk.world_cols(world))
