"""The port's camera, renderers and vision env against the JAX package on
the same inputs: camera math, ``camera_pose``, ``pixel_ray_grid``, the
raycast (``render_depth_raycast``) and splat (``render_depth_image``)
renderers, the target-pixel helpers, the render banks, per-env randomized
worlds, and ``VisionAcroEnv`` observations for all three renderers.

Tolerances: the renderers quantise to uint8 levels and are compared level
for level on the same camera poses. After one env step the drone states of
the two packages differ by float32 ulps, which can move a silhouette edge by
a pixel, so post-step frames may differ on at most 0.5 % of the pixels.
Raw raycast depths agree to 1e-6 relative (XLA may contract a multiply-add
that PyTorch rounds twice). Camera math runs in float64 (the test process
runs JAX with x64 on) and agrees to 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.envs.vision_acro import VisionAcroEnv as JVis
from fpyv_tpu.ops import camera_ops as jco
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.vision import raycast as jray
from fpyv_tpu.vision import renderer as jren
from fpyv_tpu.vision.camera import CameraRig as JRig, camera_pose as jpose
from fpyv_tpu.world import randomize as jrand
from fpyv_tpu.world.generators import WorldSpec as JSpec
from fpyv_tpu.world.render_bank import build_dynamic_render_bank as jdyn
from fpyv_tpu.world.render_bank import build_render_bank as jbank
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.config import FpyvConfig as TCfg
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv as TVis
from fpyv_tpu_torch.ops import camera_ops as tco
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.vision import raycast as tray
from fpyv_tpu_torch.vision import renderer as tren
from fpyv_tpu_torch.vision.camera import CameraRig as TRig, camera_pose as tpose
from fpyv_tpu_torch.world import randomize as trand
from fpyv_tpu_torch.world.generators import WorldSpec as TSpec
from fpyv_tpu_torch.world.render_bank import build_dynamic_render_bank as tdyn
from fpyv_tpu_torch.world.render_bank import build_render_bank as tbank

RIG = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0, resolution=(96, 72))
N = 8


def _tw(jworld):
    return interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")


def _poses(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
    pos = rng.uniform([-8, -8, 0.5], [8, 8, 6.0], (n, 3))
    return pos.astype(dtype), R.astype(dtype)


def _params_world(seed=1):
    jspec = JSpec.from_config(__import__("fpyv_tpu.config").config.SimulatorConfig(), seed=seed)
    tspec = TSpec.from_config(TCfg().simulator, seed=seed)
    return jspec, tspec


# ---------------------------------------------------------------------------
# Camera math
# ---------------------------------------------------------------------------

PTS = np.random.default_rng(0).normal(size=(5, 7, 3)) * 4
CAM_T = np.random.default_rng(1).normal(size=(5, 3))
CAM_R = _poses(5, 2, np.float64)[1]
PIX = np.random.default_rng(3).uniform([0, 0], [96, 72], (5, 2))
K_INV = JRig(**RIG).K_inv

CAMERA_CASES = {
    "intrinsic_matrix": lambda m: m.intrinsic_matrix(
        200.0, 210.0, 48.0, 36.0, **({"dtype": torch.float64, "device": "cpu"}
                                     if m is tco else {"dtype": jnp.float64})),
    "world_to_camera": lambda m, t=None: m.world_to_camera(*_args(m, PTS, CAM_R, CAM_T)),
    "project_camera_points": lambda m: m.project_camera_points(
        *_args(m, PTS + [0, 0, 9.0], JRig(**RIG).K)),
    "pixel_to_direction": lambda m: m.pixel_to_direction(*_args(m, PIX), K_INV,
                                                         _args(m, CAM_R)[0]),
    "bbox3d_corners": lambda m: m.bbox3d_corners(*_args(m, PTS)),
}


def _args(m, *xs):
    return [torch.from_numpy(np.asarray(x)) if m is tco else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("name", sorted(CAMERA_CASES))
def test_camera_op_matches_jax(name):
    a, b = CAMERA_CASES[name](tco), CAMERA_CASES[name](jco)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-12)


def test_rig_and_pose_match_jax():
    jr, tr = JRig(**RIG), TRig(**RIG)
    for k in ("K", "K_inv", "mount_rotation"):
        np.testing.assert_array_equal(getattr(tr, k), getattr(jr, k))
    assert tco.focal_length_from_fov(120.0, 96) == jco.focal_length_from_fov(120.0, 96)
    np.testing.assert_array_equal(tray.pixel_ray_grid(tr), jray.pixel_ray_grid(jr))
    pos, R = _poses(N, 4)
    jp, jR = jpose(jr, jnp.asarray(pos), jnp.asarray(R))
    tp, tR = tpose(tr, torch.from_numpy(pos), torch.from_numpy(R))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-6)


# ---------------------------------------------------------------------------
# Renderers
# ---------------------------------------------------------------------------


def _cams(seed):
    pos, R = _poses(N, seed)
    jp, jR = jpose(JRig(**RIG), jnp.asarray(pos), jnp.asarray(R))
    return (jp, jR), (torch.from_numpy(np.array(jp)), torch.from_numpy(np.array(jR)))


@pytest.mark.parametrize("ground_extent", [None, 15.0])
def test_raycast_matches_jax(ground_extent):
    jspec, tspec = _params_world()
    from fpyv_tpu.world.generators import build_world as jbuild
    from fpyv_tpu_torch.world.generators import build_world as tbuild

    jw, tw = jbuild(jspec, dtype=jnp.float32), tbuild(tspec, device="cpu")
    (jp, jR), (tp, tR) = _cams(5)
    kw = dict(max_depth=25.0, ground_extent=ground_extent)
    ref = np.asarray(jray.render_depth_raycast(JRig(**RIG), jp, jR, jw, **kw))
    out = tray.render_depth_raycast(TRig(**RIG), tp, tR, tw, **kw).numpy()
    assert (ref > 0).mean() > 0.1
    np.testing.assert_array_equal(out, ref)
    t_ref = np.asarray(jray.raycast_depth(JRig(**RIG), jp, jR, jw))
    t_out = tray.raycast_depth(TRig(**RIG), tp, tR, tw).numpy()
    np.testing.assert_allclose(t_out, t_ref, rtol=1e-6)  # XLA may fuse a multiply-add


def test_render_banks_equal():
    jspec, tspec = _params_world(3)
    for a, b in ((jbank(jspec), tbank(tspec)), (jdyn(n_spheres=2, n_cylinders=4, ground=None),
                                                tdyn(n_spheres=2, n_cylinders=4, ground=None))):
        for k, v in vars(a).items():
            np.testing.assert_array_equal(getattr(b, k), v, err_msg=k)


def test_splat_matches_jax():
    jspec, tspec = _params_world(2)
    from fpyv_tpu.world.generators import build_world as jbuild
    from fpyv_tpu_torch.world.generators import build_world as tbuild

    jw, tw = jbuild(jspec, dtype=jnp.float32), tbuild(tspec, device="cpu")
    (jp, jR), (tp, tR) = _cams(6)
    ref = np.asarray(jren.render_depth_image(JRig(**RIG), jp, jR, jbank(jspec), world=jw,
                                             max_depth=25.0))
    out = tren.render_depth_image(TRig(**RIG), tp, tR, tbank(tspec), world=tw,
                                  max_depth=25.0).numpy()
    assert (ref > 0).mean() > 0.01
    np.testing.assert_array_equal(out, ref)
    bref = np.asarray(jren.render_binary_image(JRig(**RIG), jp, jR, jbank(jspec), world=jw))
    bout = tren.render_binary_image(TRig(**RIG), tp, tR, tbank(tspec), world=tw).numpy()
    np.testing.assert_array_equal(bout, bref)
    c_ref, f_ref = jren.target_pixel_centroid(jnp.asarray(ref))
    c_out, f_out = tren.target_pixel_centroid(torch.from_numpy(out))
    np.testing.assert_allclose(c_out.numpy(), np.asarray(c_ref), atol=1e-4)
    np.testing.assert_array_equal(f_out.numpy(), np.asarray(f_ref))
    target = jw.sphere_center[0]
    u_ref, v_ref = jren.project_point_pixel(JRig(**RIG), jp, jR, target)
    u_out, v_out = tren.project_point_pixel(TRig(**RIG), tp, tR, tw.sphere_center[0])
    np.testing.assert_allclose(u_out.numpy(), np.asarray(u_ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(v_out.numpy(), np.asarray(v_ref))


def test_batched_splat_matches_jax():
    jw = jrand.sample_worlds(jax.random.key(2), N, n_spheres=2, n_cylinders=3)
    tw = _tw(jw)
    (jp, jR), (tp, tR) = _cams(7)
    ref = np.asarray(jren.render_depth_image(JRig(**RIG), jp, jR, jdyn(n_spheres=2, n_cylinders=3, ground=None), world=jw,
                                             max_depth=25.0))
    out = tren.render_depth_image(TRig(**RIG), tp, tR, tdyn(n_spheres=2, n_cylinders=3, ground=None), world=tw,
                                  max_depth=25.0).numpy()
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# Randomized worlds: same distributions (the streams differ)
# ---------------------------------------------------------------------------


def test_sample_worlds_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    tw = trand.sample_worlds(g, 4096, n_spheres=1, n_cylinders=4, device="cpu")
    jw = jrand.sample_worlds(jax.random.key(0), 8, n_spheres=1, n_cylinders=4)
    a, b = interop.world_to_numpy(tw), interop.to_numpy_tree(jw)
    for k in a:
        assert a[k].shape[1:] == b[k].shape[1:] and a[k].dtype == b[k].dtype, k
    r = trand.WorldRanges()
    assert r.target_radius[0] <= a["sphere_radius"].min() < a["sphere_radius"].max() \
        <= r.target_radius[1]
    assert abs(a["cyl_center"][..., :2].std() - r.cyl_xy_std) < 0.3
    np.testing.assert_array_equal(a["sphere_path_center"], a["sphere_center"])
    cw = trand.curriculum_worlds(torch.Generator().manual_seed(0), 64, 0.5, device="cpu")
    assert cw.cyl_active.sum(-1).tolist() == [2] * 64  # ceil(0.5 * 4) obstacles


# ---------------------------------------------------------------------------
# VisionAcroEnv
# ---------------------------------------------------------------------------


def _env_pair(renderer, target_only, **kw):
    common = dict(pos_low=(4.0, -7.0, 2.0), pos_high=(7.0, -4.0, 5.0))  # clear of obstacles
    jenv = JVis(acro=JEnv(params=JP(att_mode="quat"), dtype=jnp.float32, **common),
                renderer=renderer, target_only=target_only, **kw)
    tenv = TVis(acro=TEnv(params=TP(att_mode="quat"), **common), renderer=renderer,
                target_only=target_only, **kw)
    return jenv, tenv


def _compare_obs(tobs, jobs, max_frac=0.0, live=slice(None)):
    a = tobs["pixels"].numpy().astype(np.float64)[live]
    b = np.asarray(jobs["pixels"]).astype(np.float64)[live]
    assert a.shape == b.shape
    diff = np.abs(a - b) > 1e-6
    assert diff.mean() <= max_frac, f"{diff.sum()} of {diff.size} pixels differ"
    for k in ("rates", "accel_z", "thrust"):
        np.testing.assert_allclose(tobs[k].numpy()[live], np.asarray(jobs[k])[live], atol=1e-4)


@pytest.mark.parametrize("renderer,target_only", [
    ("splat", True), ("splat", False), ("raycast", True), ("raycast", False),
    ("raycast_pallas", True), ("raycast_pallas", False)])
def test_vision_env_obs_match_jax(renderer, target_only):
    jenv, tenv = _env_pair(renderer, target_only)
    jworld, jb = jenv.make_world(seed=1)
    tworld, tb = tenv.make_world(seed=1, device="cpu")
    keys = jax.random.split(jax.random.key(0), N)
    js, jobs = jenv.reset_batched(keys, jworld, jb)
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    _compare_obs(tenv._obs(ts, tworld, tb), jobs)  # same state: same frames
    act = np.zeros((N, 4), np.float32)
    act[:, 3] = -0.6
    js, jobs, jr, jd, jinfo = jenv.step_batched(js, jnp.asarray(act), jworld, jb)
    ts, tobs, tr, td, tinfo = tenv.step_batched(ts, torch.from_numpy(act), tworld, tb)
    # envs that crashed restart from either package's own draws: compare the rest
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    live = ~td.numpy()
    assert live.sum() >= N // 2
    _compare_obs(tobs, jobs, max_frac=5e-3, live=live)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_array_equal(tinfo["target_visible"].numpy()[live],
                                  np.asarray(jinfo["target_visible"])[live])
    np.testing.assert_allclose(tinfo["target_pixel"].numpy()[live],
                               np.asarray(jinfo["target_pixel"])[live], atol=0.5)


@pytest.mark.parametrize("renderer", ["splat", "raycast_pallas"])
def test_vision_env_batched_worlds_match_jax(renderer):
    jenv, tenv = _env_pair(renderer, False)
    jworlds, jb = jenv.make_randomized_worlds(jax.random.key(3), N)
    tworlds = _tw(jworlds)
    _, tb = tenv.make_randomized_worlds(torch.Generator(), N, device="cpu")
    keys = jax.random.split(jax.random.key(1), N)
    js, jobs = jenv.reset_batched(keys, jworlds, jb)
    ts = interop.acro_state_from_numpy(interop.to_numpy_tree(js), "cpu")
    _compare_obs(tenv._obs(ts, tworlds, tb), jobs)


def test_pixel_dtype_u8_matches_raycast_levels():
    _, a = _env_pair("raycast", False, pixel_dtype="u8")
    _, b = _env_pair("raycast_pallas", False, pixel_dtype="u8")
    world, bank = a.make_world(seed=1, device="cpu")
    st, oa = a.reset_batched(torch.Generator().manual_seed(0), world, bank, N)
    ob = b._obs(st, world, bank)
    assert oa["pixels"].dtype == ob["pixels"].dtype == torch.uint8
    torch.testing.assert_close(ob["pixels"], oa["pixels"], atol=0, rtol=0)
    with pytest.raises(ValueError, match="renderer"):
        TVis(renderer="bogus")
