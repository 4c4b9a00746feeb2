"""The port's CUDA kernels K2-K8 against their plain PyTorch versions on
the card. Imports neither JAX nor ``fpyv_tpu``, so it runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX). Every test needs a
CUDA device and skips without one: the kernels have no CPU or interpret mode.

Tolerances: the kernels are built with --fmad=false and without fast math,
so they round as the plain versions do and differ by libm ulps at most
(sinf/cosf/logf on the card against PyTorch's own CUDA kernels): 1e-5 after
one step, 1e-4 after 64 chained steps, 1e-3 on 64-step reward sums. The step
counter t, and with it every reset decision, is equal exactly; K3 and K4,
whose lanes share an env and add its contact terms in the plain order, equal
their plain versions bit for bit (max abs error 0.0). K5's depth
levels are equal, on the render edge worlds too. K6 (the chase) holds pos 1e-4, velocity and attitude 1e-3
and reward sums 2e-3 after K = 64 steps (tests/test_pallas_vision.py's
tolerances); its t, crash and contact counts are equal. K7 (the policy
rollout) in float32 sums its products in the plain version's order: frames,
crash flags and t equal, everything else within the CPU tests' tolerances
(tests/test_torch_policy_kernel.py). In bf16 its products run on the tensor
cores, which sum in the hardware's order, so a low-bit difference in an
action could fork a trajectory: the bf16 cases are teacher-forced (the plain
env takes the kernel's actions), with frames, flags and t still equal and
the policy's mean and value within TOL_BF16_HEADS (4e-3,
tests/test_torch_actor_order.py) of the kernel's. K8 (the race rollout)
likewise: frames (the stacks), env ends, t, next gate, gates passed and the
flush flag equal, the rest within K7's tolerances. The state net
(``ActorCritic``, float32, TF32 off) holds its CPU outputs within 1e-5; so
do the conv and GRU pixel nets in float32, inside their ``flax_reductions``
scope (cuBLAS's bf16 reduced-precision reductions and cuDNN's TF32 off:
Flax's float32 sums, one rounding). In bf16 the libraries sum in another
order than the CPU and cuDNN's bf16 convolutions are not all correctly
rounded, so a few of a layer's outputs land off: the bf16 nets are
teacher-forced layer by layer (within one bf16 step at the layer's largest
output, at most 1 % of its outputs off; the float32 GRU and heads on the
CPU's features within 1e-5). K5 renders the 4-agent race, the opponents and
obstacles as per-camera spheres, with levels equal. SAC's nets hold their
CPU outputs within 1e-5 and one SAC update (the same replay and draws)
its losses within 1e-6 + 1e-5 relative and every parameter within 1e-6 +
1e-4 relative; the SAC and ES trainers launch no kernel. Two gloo ranks
sharing the card replay one process's fixed-action rollouts bit for bit.
K5 renders play's video frames (one camera at 640x480) with levels equal to
its plain version; the simulator (no kernel) on the card holds the CPU's
run within tests/test_torch_simulator.py's crash tolerance. The secondary
paths (no kernel) hold the CPU's run from the same generator's draws:
``SensorAcroEnv`` 1e-4 on the observation over 8 steps, the hover env and
its pilot 1e-4 m over 60 steps, the geometry algorithms 1e-9 in float64,
``attention`` and the terrain heightmap in float32 within 1e-5 of the
largest value (TF32 off). Any motor count and fc width: K3 and K4 at 3, 6
and 8 motor points (and 16 on a world whose staged terms do not fit a
block, one thread an env) equal to their plain versions bit for bit, K6
with 6 and 8 at its tolerances, K7 and K8 with 384-, 520- and 200-wide fc
layers (a hexacopter's env) as the 256-wide cases: float32 equal to the
plain version's frames and flags within its tolerances, bf16
teacher-forced. K7 and K8 on edge worlds (a camera inside a sphere, an
obstacle or an open tube, on the ground plane or in a gate's plane;
inactive primitives; rays down a tube's axis; a gate behind the camera; the
ground clipped, left out of the render or off) at 64 envs and at 13 (a
last block of 5) as the cases above. The PPO learner's minibatch update
replayed from CUDA graphs equals the same update run eagerly with the same
capturable Adam, losses and weights bit for bit; against the Adam that takes
its bias corrections on the host it holds the losses within 1e-4 and the
weights within 4e-3 after 48 steps (measured 7.2e-6 and 1.2e-3). With the
net's uint8 input through levels_lut inside the graphs, the learner equals
the eager one on the old input chain bit for bit
(``tests/test_torch_levels_lut.py`` holds the kernel itself).
"""

import copy

import numpy as np
import pytest
import torch

from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv, default_vision_rig
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import env_kernel as ek
from fpyv_tpu_torch.ops import step_kernel as sk
from fpyv_tpu_torch.ops import policy_kernel as pk
from fpyv_tpu_torch.ops import race_kernel as rk
from fpyv_tpu_torch.ops import vision_kernel as vk
from fpyv_tpu_torch.physics.drone import DroneParams, drone_reset
from fpyv_tpu_torch.world.generators import WorldSpec, build_world, contact_start, contact_world


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _bank(device, world="default", n=256, n_motors=4, **kw):
    """An env, its world, a reset bank of n envs and the hover action. The
    "contact" world is ``contact_world`` with the drones at its gaps
    (``contact_start``): several motor points on a sphere and a cylinder in
    one step."""
    env = AcroEnv(params=DroneParams(att_mode="quat", n_motors=n_motors), **kw)
    if world == "default":
        w = env.default_world(device)
    elif world == "contact":
        w = contact_world(device=device)
    else:
        w = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=device)
    g = torch.Generator().manual_seed(0)
    st, _ = env.reset(g, w, (n,))
    if world == "contact":
        pos, vel, ypr = (torch.from_numpy(a).to(device) for a in contact_start(n, 17))
        st = st.replace(drone=drone_reset(env.params, pos, vel, ypr))
    act = torch.zeros(n, 4, device=device)
    act[:, 3] = -0.6
    return env, w, st, act


# K3 and K4 cases: the default and params.yaml worlds, a contact-heavy start
# on 2 spheres and 8 cylinders, ragged N (one env past a block of 32, one env
# in the last block), and a bank past ek.ONE_THREAD_ENVS (one thread an env)
K34_CASES = [pytest.param("default", 256, id="default"), pytest.param("params", 256, id="params"),
             pytest.param("contact", 256, id="contact"), pytest.param("default", 33, id="ragged33"),
             pytest.param("params", 4097, id="ragged4097"),
             pytest.param("params", 32773, id="one_thread32773")]


@pytest.mark.cuda
@pytest.mark.parametrize("world,n", K34_CASES)
def test_cuda_k2_k3_match_plain(cuda_device, world, n):
    """K2 within libm ulps; K3 (lanes on an env) equal bit for bit to its
    plain version, and to itself launch after launch."""
    env, w, st, act = _bank(cuda_device, world, n)
    s, a = sk.state_to_matrix(st.drone), sk.action_matrix(act)
    sph = sk.sphere_matrix(w)
    cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
    out = sk.launch_drone_step(env.params, s, a, sph, cyl)
    torch.cuda.synchronize()
    ref = sk.drone_step_reference(env.params, s, a, sph, cyl)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    out = sk.launch_rollout(env.params, s, a, sph, 64, cyl)
    torch.cuda.synchronize()
    ref = sk.rollout_reference(env.params, s, a, sph, 64, cyl)
    if world == "contact":
        assert ref[14].sum() > 0  # premise: motor points inside the obstacles
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(sk.launch_rollout(env.params, s, a, sph, 64, cyl), out, atol=0,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("world,n", K34_CASES)
@pytest.mark.parametrize("kw", [pytest.param(dict(max_episode_steps=20), id="kw0"),
                                pytest.param(dict(max_episode_steps=20, randomize=True,
                                                  wind=(1.0, 0.5, 0.0), wind_scale=0.5),
                                             id="kw1")])
def test_cuda_k4_matches_plain_across_resets(cuda_device, world, n, kw):
    """K4 equal bit for bit to its plain version across resets (t, done and
    the reset count too), to itself launch after launch, and its
    instrumented instantiation to its plain one."""
    env, w, st, act = _bank(cuda_device, world, n, **kw)
    s, a = ek.env_state_to_matrix(st), sk.action_matrix(act)
    wm = ek.env_world_matrix(w)
    cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
    out, rsum = ek.launch_env_rollout(env, s, a, wm, 64, seed=3, cyl_mat=cyl)
    torch.cuda.synchronize()
    ref, ref_rsum, resets = ek.env_rollout_reference(env, s, a, wm, 64, seed=3, cyl_mat=cyl)
    assert resets >= n  # premise: every env's 20-step episode ended
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(rsum, ref_rsum, atol=0, rtol=0)
    again = ek.launch_env_rollout(env, s, a, wm, 64, seed=3, cyl_mat=cyl)
    torch.testing.assert_close(again[0], out, atol=0, rtol=0)
    torch.testing.assert_close(again[1], rsum, atol=0, rtol=0)
    probe = torch.zeros(ek.N_ENV_PROBE, dtype=torch.int64, device=cuda_device)
    if n >= ek.ONE_THREAD_ENVS:  # the instrumented instantiation is the lane design's
        with pytest.raises(ValueError, match="lane design"):
            ek.launch_env_rollout(env, s, a, wm, 64, seed=3, cyl_mat=cyl, probe=probe)
        return
    timed = ek.launch_env_rollout(env, s, a, wm, 64, seed=3, cyl_mat=cyl, probe=probe)
    torch.cuda.synchronize()
    torch.testing.assert_close(timed[0], out, atol=0, rtol=0)
    torch.testing.assert_close(timed[1], rsum, atol=0, rtol=0)
    split = ek.env_probe_split(probe, n)
    assert split["resets"] == resets
    assert all(split[k] > 0 for k in ek.ENV_PHASES)


# Any motor count (DroneParams.n_motors, 2 to 16): the generic
# instantiation of K1's contact loop; K3 and K4 stage n_motors points' terms
# (lane m owns points m, m + 4, ...) and sum them in the plain order.
MOTOR_CASES = [pytest.param("contact", 256, 6, id="contact-m6"),
               pytest.param("contact", 256, 8, id="contact-m8"),
               pytest.param("contact", 4097, 3, id="contact4097-m3"),
               pytest.param("params", 32773, 6, id="one_thread32773-m6")]


@pytest.mark.cuda
@pytest.mark.parametrize("world,n,n_motors", MOTOR_CASES)
def test_cuda_k3_k4_any_motor_count(cuda_device, world, n, n_motors):
    """K3 and K4 with 3, 6 and 8 motor points equal bit for bit to their plain
    versions (K4 across resets), on the contact-heavy start."""
    env, w, st, act = _bank(cuda_device, world, n, n_motors=n_motors, max_episode_steps=20)
    s, a = sk.state_to_matrix(st.drone), sk.action_matrix(act)
    sph = sk.sphere_matrix(w)
    cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
    out = sk.launch_rollout(env.params, s, a, sph, 64, cyl)
    torch.cuda.synchronize()
    ref = sk.rollout_reference(env.params, s, a, sph, 64, cyl)
    if world == "contact":
        assert ref[14].sum() > 0  # premise: motor points inside the obstacles
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    es, wm = ek.env_state_to_matrix(st), ek.env_world_matrix(w)
    out, rsum = ek.launch_env_rollout(env, es, a, wm, 64, seed=3, cyl_mat=cyl)
    torch.cuda.synchronize()
    ref, ref_rsum, resets = ek.env_rollout_reference(env, es, a, wm, 64, seed=3, cyl_mat=cyl)
    assert resets >= n  # premise: every env's 20-step episode ended
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    torch.testing.assert_close(rsum, ref_rsum, atol=0, rtol=0)
    probe = torch.zeros(ek.N_ENV_PROBE, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="quad|lane design"):  # the quad's lane design only
        ek.launch_env_rollout(env, es, a, wm, 64, seed=3, cyl_mat=cyl, probe=probe)


@pytest.mark.cuda
def test_cuda_k3_k4_one_thread_when_the_stage_does_not_fit(cuda_device):
    """16 motors on a world of 24 spheres and 8 cylinders: 16 x 33 staged
    terms of 32 envs pass a block's shared memory, so K3 and K4 run one
    thread an env below kOneThreadEnvs; K3 still equals its plain version."""
    from fpyv_tpu_torch.physics.world import empty_world

    env, _, st, act = _bank(cuda_device, "default", 256, n_motors=16)
    g = torch.Generator().manual_seed(4)
    S, C = 24, 8
    w = empty_world(n_spheres=S, n_cylinders=C, ground=True, device="cpu").replace(
        sphere_center=torch.rand(S, 3, generator=g) * 20.0 - 10.0,
        cyl_center=torch.rand(C, 3, generator=g) * 20.0 - 10.0).to(cuda_device)
    s, a = sk.state_to_matrix(st.drone), sk.action_matrix(act)
    sph, cyl = sk.sphere_matrix(w), sk.cylinder_matrix(w)
    kc = sk.step_constants_array(env.params)
    lib = _build.library()
    assert lib.fpyv_rollout_lanes(kc.ctypes.data, kc.size, S, C, 256) == 1
    assert lib.fpyv_env_rollout_lanes(kc.ctypes.data, kc.size, S, C, 256) == 1
    assert lib.fpyv_rollout_lanes(kc.ctypes.data, kc.size, 1, 0, 256) == 4
    out = sk.launch_rollout(env.params, s, a, sph, 16, cyl)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, sk.rollout_reference(env.params, s, a, sph, 16, cyl), atol=0,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_motors", [6, 8])
def test_cuda_k6_any_motor_count(cuda_device, n_motors):
    env, w, st, _ = _bank(cuda_device, "default", n=64, n_motors=n_motors, max_episode_steps=20)
    rig = default_vision_rig()
    s, wm = vk.chase_state_matrix(st), ek.env_world_matrix(w)
    out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s, wm, 64, rig, seed=3)
    torch.cuda.synchronize()
    ref, ref_rsum, resets, ref_crashes, ref_contacts = vk.vision_env_rollout_reference(
        env, s, wm, 64, rig, seed=3)
    assert resets >= 64  # premise: every env reset
    torch.testing.assert_close(out[15], ref[15], atol=0, rtol=0)
    torch.testing.assert_close(crashes, ref_crashes, atol=0, rtol=0)
    torch.testing.assert_close(contacts, ref_contacts, atol=0, rtol=0)
    torch.testing.assert_close(out[0:3], ref[0:3], atol=1e-4, rtol=0)
    torch.testing.assert_close(out[3:6], ref[3:6], atol=1e-3, rtol=0)
    torch.testing.assert_close(rsum, ref_rsum, atol=2e-3, rtol=0)
    probe = torch.zeros(vk.N_CHASE_PROBE, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="quad"):
        vk.launch_vision_env_rollout(env, s, wm, 64, rig, seed=3, probe=probe)


@pytest.mark.cuda
def test_cuda_entry_points_launch_and_count(cuda_device):
    """The public wrappers take CUDA states to the kernels (never the plain
    version) and count one launch each."""
    env, w, st, act = _bank(cuda_device, n=64)
    _build.reset_launch_counts()
    stepped = sk.fused_drone_step(env.params, st.drone, act, w)
    rolled = sk.fused_rollout(env.params, st.drone, act, w, 8)
    out, w2, rsum = ek.fused_env_rollout(env, st, act, w, 8, seed=1)
    torch.cuda.synchronize()
    for renderer in ("raycast_pallas", "raycast"):  # both names run K5
        _, obs = VisionAcroEnv(acro=env, renderer=renderer, target_only=False).reset_batched(
            torch.Generator().manual_seed(1), w, None, 64)
    chased = vk.fused_vision_env_rollout(env, st, w, 4, seed=1)
    pw, pst, pnet = _policy_setup(cuda_device, 64, 8, pool=1, bf16=True)
    frames, _, aux, _ = pk.fused_policy_vision_rollout(pw[0], pw[1], pst, pw[2],
                                                       pk.build_policy_weights(pnet), 4, 1, 25.0)
    venv, world, cols, hist, rnet = _race_setup(cuda_device, 64, 2, 3, 8, bf16=True)
    rframes, _, raux, _ = rk.fused_race_vision_rollout(venv, cols, hist, world,
                                                       pk.build_policy_weights(rnet), 4, 1)
    torch.cuda.synchronize()
    assert _build.launch_counts == {"drone_step": 1, "rollout": 1, "env_rollout": 1,
                                    "render_depth": 2, "vision_env_rollout": 1,
                                    "policy_vision_rollout": 1, "race_vision_rollout": 1,
                                    "levels_lut": 0}
    assert rframes.is_cuda and torch.isfinite(raux).all()
    assert frames.is_cuda and torch.isfinite(aux).all()
    assert obs["pixels"].is_cuda and chased[0].drone.pos.is_cuda
    assert stepped.pos.is_cuda and rolled.pos.is_cuda and out.drone.pos.is_cuda
    assert rsum.shape == (64,) and torch.isfinite(rsum).all()
    assert int(w2.sphere_path_count[0] - w.sphere_path_count[0]) == 8


@pytest.mark.cuda
def test_cuda_launches_refuse_bad_inputs(cuda_device):
    env, w, st, act = _bank(cuda_device, n=64)
    s, sph = sk.state_to_matrix(st.drone), sk.sphere_matrix(w)
    a = sk.action_matrix(act)
    with pytest.raises(TypeError, match="float32"):
        sk.launch_drone_step(env.params, s.double(), a, sph)
    with pytest.raises(ValueError, match="contiguous"):
        sk.launch_drone_step(env.params, s.T.contiguous().T, a, sph)
    with pytest.raises(ValueError, match="on cpu"):
        sk.launch_drone_step(env.params, s, a.cpu(), sph)
    # a CUDA state into a call whose world was built on the CPU
    cpu_world = env.default_world("cpu")
    with pytest.raises(ValueError, match="on cpu"):
        vk.fused_vision_env_rollout(env, st, cpu_world, 4)
    with pytest.raises(ValueError, match="on cpu"):
        vk.fused_render_depth(default_vision_rig(), st.drone.pos, torch.eye(3, device=cuda_device)
                              .expand(64, 3, 3), cpu_world)


def _random_world(device, n, seed):
    from fpyv_tpu_torch.world.randomize import sample_worlds

    return sample_worlds(torch.Generator().manual_seed(seed), n, n_spheres=2, n_cylinders=4,
                         device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("world,res", [("params", (96, 72)), ("batched", (96, 72)),
                                       ("params", (640, 480)), ("edge", (96, 72)),
                                       ("edge", (33, 17)), ("edge", (640, 480)),
                                       ("edge_clipped", (96, 72)), ("edge_no_ground", (33, 17))])
def test_cuda_k5_matches_plain(cuda_device, world, res):
    """K5's levels equal the plain render's, on the edge worlds too
    (``render_edge_bank``, as K7's edge cases: where the per-pixel render's
    early exits decide pixels), the ground clipped or left out."""
    env, w, st, _ = _bank(cuda_device, "params", n=64)
    rig = vk.CameraRig(resolution=res)
    cam_pos, cam_R = VisionAcroEnv(acro=env, rig=rig)._camera(st)
    include, extent = pk.INCLUDE, None
    if world == "batched":
        w = _random_world(cuda_device, 64, 3)
    elif world.startswith("edge"):
        from fpyv_tpu_torch.ops.rotations import quat_to_rotmat
        from fpyv_tpu_torch.vision.camera import camera_pose
        from fpyv_tpu_torch.world.generators import render_edge_bank

        w, pos, quat = render_edge_bank(64, rig, device=cuda_device)
        pos, quat = (torch.from_numpy(x).to(cuda_device) for x in (pos, quat))
        cam_pos, cam_R = camera_pose(rig, pos, quat_to_rotmat(quat))
        extent = 4.0 if world == "edge_clipped" else None
        include = NO_GROUND if world == "edge_no_ground" else pk.INCLUDE
    cfg = vk.RenderConfig.for_world(w, 25.0, include, extent)
    dcam = torch.from_numpy(vk.flat_dcam(rig)).to(cuda_device)
    cam, wcol = vk.camera_matrix(cam_pos, cam_R), vk.world_cols(w)
    out = vk.launch_render_depth(cfg, dcam, cam, wcol)
    torch.cuda.synchronize()
    ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
    assert (ref > 0).float().mean() > 0.05  # premise: the scene is in view
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("world,kw", [("default", dict(max_episode_steps=20)),
                                      ("params", dict(randomize=True, wind=(1.0, 0.5, 0.0),
                                                      wind_scale=0.5))])
def test_cuda_k6_matches_plain_across_resets(cuda_device, world, kw):
    env, w, st, _ = _bank(cuda_device, world, n=64, **kw)
    rig = default_vision_rig()
    s = vk.chase_state_matrix(st)
    wm = ek.env_world_matrix(w)
    cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
    out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s, wm, 64, rig, seed=3,
                                                                cyl_mat=cyl)
    torch.cuda.synchronize()
    ref, ref_rsum, resets, ref_crashes, ref_contacts = vk.vision_env_rollout_reference(
        env, s, wm, 64, rig, seed=3, cyl_mat=cyl)
    if world == "default":
        assert resets >= 64  # premise: every env reset
    torch.testing.assert_close(out[15], ref[15], atol=0, rtol=0)  # t: resets equal
    torch.testing.assert_close(crashes, ref_crashes, atol=0, rtol=0)
    torch.testing.assert_close(contacts, ref_contacts, atol=0, rtol=0)
    torch.testing.assert_close(out[0:3], ref[0:3], atol=1e-4, rtol=0)
    torch.testing.assert_close(out[3:6], ref[3:6], atol=1e-3, rtol=0)
    qerr = torch.minimum((out[6:10] - ref[6:10]).abs().amax(0), (out[6:10] + ref[6:10]).abs()
                         .amax(0))
    assert qerr.max().item() < 1e-3
    torch.testing.assert_close(rsum, ref_rsum, atol=2e-3, rtol=0)


def _gate_world(device):
    """Three gates of shapes 0, 1 and 2 on a 6 m track, cylinders, a sphere."""
    w = build_world(WorldSpec.from_config(SimulatorConfig(track={
        "count": 3, "radius": 6, "gate_size": 2, "gate_resolution": 17}), seed=2), device=device)
    return w.replace(gate_shape=torch.tensor([0, 1, 2], dtype=torch.int32, device=device),
                     sphere_center=torch.tensor([[0.0, 0.0, 3.0]], device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("res,world", [((33, 17), "params"), ((640, 480), "gates")])
def test_cuda_k5_ragged_tiles_and_gate_shapes(cuda_device, res, world):
    """K5 on a frame that is not a multiple of its 1024-pixel tile (33x17)
    and at 640x480 on a gate of each shape: levels equal."""
    env, w, st, _ = _bank(cuda_device, "params", n=64)
    if world == "gates":
        w = _gate_world(cuda_device)
        st, _ = env.reset(torch.Generator().manual_seed(4), w, (64,))
    rig = vk.CameraRig(resolution=res)
    cam_pos, cam_R = VisionAcroEnv(acro=env, rig=rig)._camera(st)
    cfg = vk.RenderConfig.for_world(w, 25.0)
    dcam = torch.from_numpy(vk.flat_dcam(rig)).to(cuda_device)
    cam, wcol = vk.camera_matrix(cam_pos, cam_R), vk.world_cols(w)
    out = vk.launch_render_depth(cfg, dcam, cam, wcol)
    torch.cuda.synchronize()
    ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
    assert (ref > 0).any()  # premise: the scene is in view
    if world == "gates":  # premise: gates in view
        no_gates = vk.RenderConfig.for_world(w, 25.0, include=("spheres", "cylinders", "ground"))
        assert (vk.render_depth_reference(no_gates, dcam, cam, wcol) != ref).any()
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _chase_placed(env, w, rig, n, c_cam):
    """A chase bank with each drone moved so that the target's centre at
    step 0 sits at c_cam in its camera's frame, and the target's pixel box
    at step 0 (the plain ``target_pixel_box``)."""
    from fpyv_tpu_torch.physics.world import update_targets

    st, _ = env.reset(torch.Generator().manual_seed(5), w, (n,))
    s = vk.chase_state_matrix(st)
    p = vk.chase_constants(rig, vk.ChasePilot(), env.params)
    cR, cpos = vk.camera_rows(p.mount, p.rel, s)
    T = update_targets(w).sphere_center[0]
    for k in range(3):
        ahead = cR[3 * k] * c_cam[0] + cR[3 * k + 1] * c_cam[1] + cR[3 * k + 2] * c_cam[2]
        s[k] = T[k] - ahead - (cpos[k] - s[k])
    cR, cpos = vk.camera_rows(p.mount, p.rel, s)
    box = vk.target_pixel_box(p, cR, cpos, [T[k].expand(n) for k in range(3)],
                              w.sphere_radius[0].expand(n), *rig.resolution)
    return s, box


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inside", "straddle", "edge", "behind", "beside"])
def test_cuda_k6_box_fallback_and_clipped_target(cuda_device, case):
    """K6 where its pixel box falls back to the full frame (the camera inside
    the target; the target across the camera plane), where the frame's edge
    clips the target, and where the target lies behind the camera or beside
    it outside the frame's cone (empty boxes): equal to the plain version at
    the chase's tolerances, and the instrumented launch counts the
    fallback."""
    env, w, _, _ = _bank(cuda_device, "default", n=8)
    rig = default_vision_rig()
    r = float(w.sphere_radius[0])
    c_cam = {"inside": (0.0, 0.0, 0.3 * r), "straddle": (1.5 * r, 0.2 * r, 0.5 * r),
             "edge": (6.0 * float(rig.K_inv[0, 2]), 0.0, 6.0), "behind": (1.0, 0.5, -4.0),
             "beside": (6.0, 0.0, 0.3)}[case]
    s, box = _chase_placed(env, w, rig, 64, c_cam)
    wm = ek.env_world_matrix(w)
    probe = torch.zeros(vk.N_CHASE_PROBE, dtype=torch.int64, device=cuda_device)
    vk.launch_vision_env_rollout(env, s, wm, 64, rig, probe=probe)
    full_steps = int(probe[len(vk.CHASE_PHASES) + 1])
    if case == "edge":  # premise: the step-0 box is culled and clipped at u = 0
        assert not box[4].any() and (box[0] == 0).all() and (box[1] > 0).all()
    elif case in ("behind", "beside"):  # premise: the step-0 box is empty
        assert not box[4].any() and (box[1] < box[0]).all()
    else:  # premise: every env took the fallback at least once
        assert box[4].all() and full_steps >= 64
    out, rsum, crashes, contacts = vk.launch_vision_env_rollout(env, s, wm, 64, rig)
    torch.cuda.synchronize()
    ref, ref_rsum, _, ref_crashes, ref_contacts = vk.vision_env_rollout_reference(
        env, s, wm, 64, rig)
    torch.testing.assert_close(out[15], ref[15], atol=0, rtol=0)
    torch.testing.assert_close(crashes, ref_crashes, atol=0, rtol=0)
    torch.testing.assert_close(contacts, ref_contacts, atol=0, rtol=0)
    torch.testing.assert_close(out[0:3], ref[0:3], atol=1e-4, rtol=0)
    torch.testing.assert_close(out[3:6], ref[3:6], atol=1e-3, rtol=0)
    qerr = torch.minimum((out[6:10] - ref[6:10]).abs().amax(0), (out[6:10] + ref[6:10]).abs()
                         .amax(0))
    assert qerr.max().item() < 1e-3
    torch.testing.assert_close(rsum, ref_rsum, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_k6_repeats_bit_for_bit_across_resets(cuda_device):
    """K6 gives the same bits launch after launch (its threads share the
    step's target centres through shared memory, ordered by barriers), and
    its reward sums stay within the plain version's tolerance."""
    env, w, st, _ = _bank(cuda_device, "default", n=256, max_episode_steps=20)
    rig = default_vision_rig()
    s, wm = vk.chase_state_matrix(st), ek.env_world_matrix(w)
    first = vk.launch_vision_env_rollout(env, s, wm, 64, rig, seed=3)
    for _ in range(4):
        again = vk.launch_vision_env_rollout(env, s, wm, 64, rig, seed=3)
        for a, b in zip(first, again):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    _, ref_rsum, resets, _, _ = vk.vision_env_rollout_reference(env, s, wm, 64, rig, seed=3)
    assert resets >= 256  # premise: every env reset
    torch.testing.assert_close(first[1], ref_rsum, atol=2e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_k6_instrumented_launch_matches_plain_launch(cuda_device):
    """The instrumented K6 computes what the main path's instantiation does."""
    env, w, st, _ = _bank(cuda_device, "default", n=64)
    rig = default_vision_rig()
    s, wm = vk.chase_state_matrix(st), ek.env_world_matrix(w)
    probe = torch.zeros(vk.N_CHASE_PROBE, dtype=torch.int64, device=cuda_device)
    timed = vk.launch_vision_env_rollout(env, s, wm, 32, rig, probe=probe)
    plain = vk.launch_vision_env_rollout(env, s, wm, 32, rig)
    torch.cuda.synchronize()
    for a, b in zip(timed, plain):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    split = vk.chase_probe_split(probe, 64, 32)
    assert all(split[k] > 0 for k in vk.CHASE_PHASES)
    assert 0 < split["pixels_per_step"] < 96 * 72
    assert 0 < split["lit_per_step"] <= split["pixels_per_step"]


# ---------------------------------------------------------------------------
# K7: the policy rollout
# ---------------------------------------------------------------------------


def _policy_setup(device, n, max_steps, pool, bf16, seed=0, hidden=(256,), n_motors=4):
    """(env, rig, worlds), the (N, 18) state and a Flax-initialised net on
    per-env sample_worlds with 1 sphere and 4 cylinders."""
    from fpyv_tpu_torch.models.policy import PixelActorCritic
    from fpyv_tpu_torch.world.randomize import sample_worlds

    env = AcroEnv(params=DroneParams(att_mode="quat", n_motors=n_motors),
                  max_episode_steps=max_steps)
    rig = default_vision_rig()
    g = torch.Generator().manual_seed(seed)
    worlds = sample_worlds(g, n, n_spheres=1, n_cylinders=4, device=device)
    st, _ = env.reset(g, worlds, (n,))
    net = PixelActorCritic(action_dim=4, n_patches=108, torso="patch", prepatched=True,
                           compute_dtype=torch.bfloat16 if bf16 else None, patch_pool=pool,
                           hidden=hidden, device=device).init_params(g)
    with torch.no_grad():  # a std that samples, and a mean head that steers
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    return (env, rig, worlds), pk.acro_state_to_cols(st), net


def _heads_tol(bf16):
    """(mean and value tolerance, value/log-prob tolerance) against the
    plain version: float32 sums in the same order; bf16 tensor-core sums."""
    return (pk.TOL_BF16_HEADS, pk.TOL_BF16_HEADS) if bf16 else (5e-5, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("pool,bf16,n", [(1, False, 64), (4, False, 64), (1, True, 64),
                                         (4, True, 64),
                                         (1, False, 13)])  # 13: a last block of 5 envs
def test_cuda_k7_matches_plain_across_resets(cuda_device, pool, bf16, n):
    (env, rig, worlds), cols, net = _policy_setup(cuda_device, n, 8, pool, bf16)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    cfg = vk.RenderConfig.for_world(worlds, 25.0)
    wcol = pk.policy_world_cols(worlds, n)
    out = pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w, 16, 5, pool)
    torch.cuda.synchronize()
    # bf16: teacher-forced, the plain env takes the kernel's actions
    ref = pk.policy_vision_rollout_reference(env, rig, cols, wcol, cfg, w, 16, 5, pool,
                                             forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    assert torch.equal(frames, ref[0])
    assert torch.equal(aux[..., 5], ref[2][..., 5]) and torch.equal(state[:, 14:16],
                                                                    ref[3][:, 14:16])
    assert (state[:, 15] < 16).all()  # premise: every env reset
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 4], ref[2][..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(aux[..., 7], ref[2][..., 7], atol=1e-4, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_k7_bf16_teacher_forced(cuda_device):
    """bf16 at 256 envs: the plain policy on the kernel's own frames gives
    the kernel's mean and value; the plain env on the kernel's own actions
    gives its rewards, crash flags and final state."""
    (env, rig, worlds), cols, net = _policy_setup(cuda_device, 256, 1000, 1, True, seed=1)
    w = pk.build_policy_weights(net, torch.bfloat16)
    cfg = vk.RenderConfig.for_world(worlds, 25.0)
    wcol = pk.policy_world_cols(worlds, 256)
    frames, extra, aux, state = pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w, 8,
                                                                3)
    torch.cuda.synchronize()
    rf, rex, raux, rstate = pk.policy_vision_rollout_reference(
        env, rig, cols, wcol, cfg, w, 8, 3, forced_actions=aux[..., :4])
    assert torch.equal(frames, rf) and torch.equal(aux[..., 5], raux[..., 5])
    torch.testing.assert_close(rex, extra, atol=1e-6, rtol=0)
    torch.testing.assert_close(raux[..., :4], aux[..., :4], atol=pk.TOL_BF16_HEADS, rtol=0)
    torch.testing.assert_close(raux[..., 6], aux[..., 6], atol=pk.TOL_BF16_HEADS, rtol=0)
    torch.testing.assert_close(raux[..., 4], aux[..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(rstate, state, atol=1e-4, rtol=0)


# Any fc width (the hidden units past the block's 256 threads, the
# tensor-core tiles past a warp's two, a bf16 width zero-padded to 16) and a
# hexacopter: float32 as the plain version, bf16 teacher-forced.
WIDE_CASES = [pytest.param(384, False, id="384-f32"), pytest.param(384, True, id="384-bf16"),
              pytest.param(200, True, id="200-bf16"), pytest.param(520, False, id="520-f32")]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,bf16", WIDE_CASES)
def test_cuda_k7_wide_fc_hexacopter(cuda_device, hidden, bf16):
    (env, rig, worlds), cols, net = _policy_setup(cuda_device, 64, 8, 1, bf16,
                                                  hidden=(hidden,), n_motors=6)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    cfg = vk.RenderConfig.for_world(worlds, 25.0)
    wcol = pk.policy_world_cols(worlds, 64)
    out = pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w, 16, 5)
    torch.cuda.synchronize()
    ref = pk.policy_vision_rollout_reference(env, rig, cols, wcol, cfg, w, 16, 5,
                                             forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    assert torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])
    assert torch.equal(state[:, 14:16], ref[3][:, 14:16])
    assert (state[:, 15] < 16).all()  # premise: every env reset
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_train_vision_launches_k7(cuda_device):
    from fpyv_tpu_torch.apps.train import train_vision

    _build.reset_launch_counts()
    res = train_vision(num_envs=64, num_iterations=3, scan_chunk=1, print_every=0)
    torch.cuda.synchronize()
    assert _build.launch_counts["policy_vision_rollout"] == 3
    assert _build.launch_counts["render_depth"] >= 3
    assert np.isfinite(res.mean_reward_last)


# ---------------------------------------------------------------------------
# K8: the race rollout
# ---------------------------------------------------------------------------


def _race_setup(device, n, K, S, max_steps, bf16, pool=1, seed=0, hidden=(256,), n_motors=4):
    """A single-agent VisionRaceEnv (96x72, 6 gates, S obstacles) on its
    track, n fresh races as the (N, 22) state, a random history and a
    Flax-initialised frame-stacked net."""
    from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
    from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv
    from fpyv_tpu_torch.models.policy import PixelActorCritic

    venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=1, max_episode_steps=max_steps,
                                           n_obstacles=S,
                                           params=DroneParams(att_mode="quat",
                                                              n_motors=n_motors)),
                         frame_stack=K)
    world = venv.default_world(device)
    g = torch.Generator().manual_seed(seed)
    st, _ = venv.race.reset(g, world, (n,))
    hist = torch.randint(0, 256, (n, 108 * (K - 1) * 64), generator=g, dtype=torch.uint8)
    net = PixelActorCritic(action_dim=4, n_patches=108, proprio_dim=11, torso="patch",
                           prepatched=True, compute_dtype=torch.bfloat16 if bf16 else None,
                           patch_pool=pool, frame_stack=K, hidden=hidden,
                           device=device).init_params(g)
    with torch.no_grad():  # a std that samples, and a mean head that steers
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    return venv, world, rk.race_state_to_cols(st), hist.to(device), net


def _race_inputs(venv, world):
    return rk.race_world_cols(world), rk.obstacle_cols(world, venv.race.n_obstacles)


@pytest.mark.cuda
@pytest.mark.parametrize("K,S,pool,bf16,n", [(2, 3, 1, False, 64), (1, 3, 4, False, 64),
                                             (3, 3, 1, True, 64), (1, 3, 1, True, 64),
                                             (4, 3, 4, True, 64),
                                             (4, 0, 1, False, 13)])  # 13: a last block of 5
def test_cuda_k8_matches_plain_across_resets(cuda_device, K, S, pool, bf16, n):
    venv, world, cols, hist, net = _race_setup(cuda_device, n, K, S, 6, bf16, pool)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    wcol, ocol = _race_inputs(venv, world)
    out = rk.launch_race_vision_rollout(venv, cols, hist, wcol, ocol, w, 16, 5, pool)
    torch.cuda.synchronize()
    # bf16: teacher-forced, the plain env takes the kernel's actions
    ref = rk.race_vision_rollout_reference(venv, cols, hist, wcol, ocol, w, 16, 5, pool,
                                           forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    assert torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])
    for c in (14, 15, 16, 19, 21):
        assert torch.equal(state[:, c], ref[3][:, c]), c
    assert (aux[..., 5].sum(0) >= 2).all()  # premise: every env ended twice
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 4], ref[2][..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(aux[..., 7], ref[2][..., 7], atol=1e-4, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_k8_bf16_teacher_forced(cuda_device):
    """bf16 at 256 envs, K = 4, 3 obstacles: the plain policy on the
    kernel's own stacks gives its mean and value; the plain env on its own
    actions gives its rewards, ends and final state."""
    venv, world, cols, hist, net = _race_setup(cuda_device, 256, 4, 3, 2000, True, seed=1)
    w = pk.build_policy_weights(net, torch.bfloat16)
    wcol, ocol = _race_inputs(venv, world)
    frames, extra, aux, state = rk.launch_race_vision_rollout(venv, cols, hist, wcol, ocol, w, 8,
                                                              3)
    torch.cuda.synchronize()
    rf, rex, raux, rstate = rk.race_vision_rollout_reference(
        venv, cols, hist, wcol, ocol, w, 8, 3, forced_actions=aux[..., :4])
    assert torch.equal(frames, rf) and torch.equal(aux[..., 5], raux[..., 5])
    torch.testing.assert_close(rex, extra, atol=1e-6, rtol=0)
    torch.testing.assert_close(raux[..., :4], aux[..., :4], atol=pk.TOL_BF16_HEADS, rtol=0)
    torch.testing.assert_close(raux[..., 6], aux[..., 6], atol=pk.TOL_BF16_HEADS, rtol=0)
    torch.testing.assert_close(raux[..., 4], aux[..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(rstate, state, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,bf16", WIDE_CASES)
def test_cuda_k8_wide_fc_hexacopter(cuda_device, hidden, bf16):
    venv, world, cols, hist, net = _race_setup(cuda_device, 64, 3, 3, 6, bf16, hidden=(hidden,),
                                               n_motors=6)
    w = pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)
    wcol, ocol = _race_inputs(venv, world)
    out = rk.launch_race_vision_rollout(venv, cols, hist, wcol, ocol, w, 16, 5)
    torch.cuda.synchronize()
    ref = rk.race_vision_rollout_reference(venv, cols, hist, wcol, ocol, w, 16, 5,
                                           forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    assert torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])
    for c in (14, 15, 16, 19, 21):
        assert torch.equal(state[:, c], ref[3][:, c]), c
    assert (aux[..., 5].sum(0) >= 2).all()  # premise: every env ended twice
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_cuda_train_vision_race_launches_k8(cuda_device):
    from fpyv_tpu_torch.apps.train import train_vision_race

    _build.reset_launch_counts()
    res = train_vision_race(num_envs=64, num_iterations=3, scan_chunk=1, print_every=0,
                            frame_stack=4, n_obstacles=3)
    torch.cuda.synchronize()
    assert _build.launch_counts["race_vision_rollout"] == 3
    assert _build.launch_counts["render_depth"] >= 3
    assert np.isfinite(res.mean_reward_last)


# ---------------------------------------------------------------------------
# The PPO learner's minibatch update replayed from CUDA graphs (rl.ppo._Graphs)
# ---------------------------------------------------------------------------

class _EagerAdam(torch.optim.Adam):
    """The capturable Adam's arithmetic on the eager path: a subclass of
    ``torch.optim.Adam`` is never graphed (``rl.ppo._graphable``)."""


def _race_rollouts(device, iterations=4, n=64):
    """The K8 trainer at ``n`` races with race_k8's learner (4 frames, 3
    obstacles, no one-hot, bf16 patch torso, T = 32, 2 epochs x 8
    minibatches), and ``iterations`` K8 rollouts recorded from its first
    state."""
    from fpyv_tpu_torch.apps.train import make_vision_race_trainer

    tr = make_vision_race_trainer(num_envs=n, num_steps=32, seed=5, frame_stack=4,
                                  n_obstacles=3, gate_onehot=False, gate_size=5.0,
                                  ent_coef=0.01, num_minibatches=8, update_epochs=2,
                                  rollout="kernel", device=device)
    st, recorded = tr.state, []
    for _ in range(iterations):
        recorded.append(tr.rollout_fn(st))
        st = st.replace(env_state=recorded[-1][0], last_obs=recorded[-1][1])
    return tr.state, recorded


def _replay_learner(state0, recorded, opt=None, **config):
    """``make_ppo`` over the recorded rollouts (iteration i learns from
    rollout i) from a copy of ``state0``; ``opt(parameters)`` replaces the
    optimizer ``init`` makes."""
    from fpyv_tpu_torch.rl import ppo

    def apply_fn(net, obs):
        px = obs["pixels"]
        return net(px.reshape(px.shape[:-1] + (108, 4 * 64)), obs["proprio"])

    cfg = ppo.PpoConfig(num_envs=recorded[0][2].reward.shape[1], num_steps=32,
                        num_minibatches=8, update_epochs=2, ent_coef=0.01, **config)
    init, iteration = ppo.make_ppo(apply_fn, None, cfg,
                                   rollout_fn=lambda st: recorded[st.update_count])
    gen = torch.Generator()
    gen.set_state(state0.generator.get_state())
    st = init(copy.deepcopy(state0.params), state0.env_state, state0.last_obs, gen)
    if opt is not None:
        st = st.replace(opt_state=opt(st.params.parameters()))
    return st, iteration


def _profiled_iterations(st, iteration, n):
    """``n`` iterations, each under the profiler: the state, the losses and
    each iteration's ``ppo.replay`` and ``ppo.capture`` span counts."""
    from torch.profiler import ProfilerActivity, profile

    from fpyv_tpu_torch.utils import profiling

    losses, replays, captures = [], [], []
    for _ in range(n):
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            st, info = iteration(st)
        names = [r.name for r in profiling.spans()]
        replays.append(names.count("ppo.replay"))
        captures.append(names.count("ppo.capture"))
        losses.append(info["loss"])
    profiling.clear_spans()
    return st, torch.stack(losses), replays, captures


# largest absolute differences of the losses and the weights: graphed against
# eager with the same Adam (the same kernels, equal), and against the Adam
# that takes its bias corrections in double on the host (an H100 read 7.2e-6
# and 1.2e-3 after 48 steps of lr 3e-4: rounding-level steps that the bf16
# forward amplifies where a weight crosses a bf16 rounding boundary)
GRAPH_VS_EAGER = 0.0
HOST_ADAM_LOSS, HOST_ADAM_WEIGHTS = 1e-4, 4e-3


def _gap(a, b) -> float:
    """The largest absolute difference between two nets' parameters."""
    with torch.no_grad():
        return max(float((x - y).abs().max()) for x, y in zip(a.parameters(), b.parameters()))


@pytest.mark.cuda
def test_cuda_ppo_graphs_replay_the_eager_update(cuda_device):
    """Three race_k8-shaped iterations graphed (capture at the second) against
    the same capturable Adam eager (``_EagerAdam``): the same kernels, so the
    losses and weights are equal. Against the Adam that takes its bias
    corrections in double on the host (not in float32 on the card) they
    agree within HOST_ADAM_LOSS and HOST_ADAM_WEIGHTS. After
    ``opt.load_state_dict`` one iteration runs eagerly, the next captures
    again, and both still agree."""
    state0, recorded = _race_rollouts(cuda_device, iterations=5)
    graphed, it_g = _replay_learner(state0, recorded)
    twin, it_e = _replay_learner(state0, recorded,
                                 opt=lambda p: _EagerAdam(p, lr=3e-4, eps=1e-5, capturable=True))
    host, it_h = _replay_learner(state0, recorded,
                                 opt=lambda p: torch.optim.Adam(p, lr=3e-4, eps=1e-5))
    assert graphed.opt_state.param_groups[0]["capturable"]
    graphed, g_loss, g_rep, g_cap = _profiled_iterations(graphed, it_g, 3)
    twin, e_loss, e_rep, _ = _profiled_iterations(twin, it_e, 3)
    host, h_loss, h_rep, _ = _profiled_iterations(host, it_h, 3)
    assert (g_rep, g_cap, e_rep, h_rep) == ([0, 16, 16], [0, 1, 0], [0] * 3, [0] * 3)
    gaps = {"twin_loss": float((g_loss - e_loss).abs().max()),
            "twin_weights": _gap(graphed.params, twin.params),
            "host_loss": float((g_loss - h_loss).abs().max()),
            "host_weights": _gap(graphed.params, host.params)}
    print("graph vs eager:", gaps)
    assert gaps["twin_loss"] <= GRAPH_VS_EAGER and gaps["twin_weights"] <= GRAPH_VS_EAGER, gaps
    assert gaps["host_loss"] <= HOST_ADAM_LOSS and gaps["host_weights"] <= HOST_ADAM_WEIGHTS, \
        gaps
    for st in (graphed, twin):  # a resume: new state tensors with the same values
        st.opt_state.load_state_dict(copy.deepcopy(st.opt_state.state_dict()))
    graphed, g_loss, g_rep, g_cap = _profiled_iterations(graphed, it_g, 2)
    twin, e_loss, _, _ = _profiled_iterations(twin, it_e, 2)
    assert (g_rep, g_cap) == ([0, 16], [0, 1])
    assert float((g_loss - e_loss).abs().max()) <= GRAPH_VS_EAGER
    assert _gap(graphed.params, twin.params) <= GRAPH_VS_EAGER


@pytest.mark.cuda
def test_cuda_levels_lut_leaves_the_graphed_learner_unchanged(cuda_device, monkeypatch):
    """Three race_k8-shaped iterations graphed, the net's uint8 input through
    levels_lut (a launch captured in each minibatch's graph), against the
    same iterations eager with the same capturable Adam and the net's old
    input chain (u8 -> float32, / its 255, the torso's bf16 cast): losses
    and weights equal bit for bit."""
    from fpyv_tpu_torch.models import policy
    from fpyv_tpu_torch.ops import levels_kernel

    state0, recorded = _race_rollouts(cuda_device, iterations=3)
    _build.reset_launch_counts()
    graphed, it_g = _replay_learner(state0, recorded)
    graphed, g_loss, g_rep, g_cap = _profiled_iterations(graphed, it_g, 3)
    assert (g_rep, g_cap) == ([0, 16, 16], [0, 1, 0])
    launched = _build.launch_counts["levels_lut"]
    assert launched > 0
    monkeypatch.setattr(policy, "levels_as", levels_kernel.levels_reference)
    twin, it_e = _replay_learner(state0, recorded,
                                 opt=lambda p: _EagerAdam(p, lr=3e-4, eps=1e-5, capturable=True))
    twin, e_loss, e_rep, _ = _profiled_iterations(twin, it_e, 3)
    assert e_rep == [0] * 3 and _build.launch_counts["levels_lut"] == launched
    assert float((g_loss - e_loss).abs().max()) <= GRAPH_VS_EAGER
    assert _gap(graphed.params, twin.params) <= GRAPH_VS_EAGER


@pytest.mark.cuda
def test_cuda_ppo_graphs_engage_only_where_they_may(cuda_device):
    """The K8, K7 and state trainers replay every minibatch from their second
    iteration on; ``AdamBf16Mu`` and a mesh axis stay eager, the mesh axis
    with the same capturable Adam, so it equals the graphed learner."""
    from fpyv_tpu_torch.apps.train import (make_acro_trainer, make_vision_race_trainer,
                                           make_vision_trainer)
    from fpyv_tpu_torch.rl import ppo

    state0, recorded = _race_rollouts(cuda_device, iterations=2)
    graphed, it_g = _replay_learner(state0, recorded)
    graphed, g_losses, g_replays, _ = _profiled_iterations(graphed, it_g, 2)
    assert g_replays == [0, 16]
    for config in (dict(adam_mu_dtype="bf16"), dict(axis_name="env")):
        st, it = _replay_learner(state0, recorded, **config)
        st, losses, replays, _ = _profiled_iterations(st, it, 2)
        assert replays == [0, 0] and bool(torch.isfinite(losses).all()), config
        assert not ppo._graphable(st.params, st.opt_state, ppo.PpoConfig(**config))
    assert st.opt_state.param_groups[0]["capturable"]  # the mesh axis's
    assert torch.equal(losses, g_losses) and _gap(st.params, graphed.params) == 0.0
    trainers = {
        "k8": (make_vision_race_trainer(num_envs=64, frame_stack=4, n_obstacles=3,
                                        device=cuda_device), 16),
        "k7": (make_vision_trainer(num_envs=64, device=cuda_device), 16),
        "acro": (make_acro_trainer(num_envs=256, num_steps=8, device=cuda_device), 32)}
    for name, (tr, per_iteration) in trainers.items():
        _, losses, replays, captures = _profiled_iterations(tr.state, tr.train_iteration, 3)
        assert replays == [0, per_iteration, per_iteration] and captures == [0, 1, 0], name
        assert bool(torch.isfinite(losses).all()), name


# ---------------------------------------------------------------------------
# K7 and K8 on edge worlds (world.generators.render_edge_bank and
# race_edge_start): where the render's early exits decide pixels, and a last
# block of 5 envs (13 envs)
# ---------------------------------------------------------------------------

NO_GROUND = ("spheres", "cylinders", "gates")


def _edge_net(device, bf16, proprio=5, K=1):
    from fpyv_tpu_torch.models.policy import PixelActorCritic

    net = PixelActorCritic(action_dim=4, n_patches=108, proprio_dim=proprio, torso="patch",
                           prepatched=True, compute_dtype=torch.bfloat16 if bf16 else None,
                           frame_stack=K, device=device)
    net.init_params(torch.Generator().manual_seed(3))
    with torch.no_grad():  # a std that samples, and a mean head that steers
        net.log_std.fill_(-0.3)
        net.pi_mean.weight.mul_(30.0)
    return pk.build_policy_weights(net, torch.bfloat16 if bf16 else None)


@pytest.mark.cuda
@pytest.mark.parametrize("extent,include,n,bf16", [
    pytest.param(None, pk.INCLUDE, 13, False, id="ground-13-f32"),
    pytest.param(4.0, pk.INCLUDE, 64, False, id="clipped-64-f32"),
    pytest.param(None, NO_GROUND, 64, False, id="no_ground-64-f32"),
    pytest.param(None, pk.INCLUDE, 64, True, id="ground-64-bf16"),
    pytest.param(4.0, pk.INCLUDE, 13, True, id="clipped-13-bf16")])
def test_cuda_k7_edge_worlds(cuda_device, extent, include, n, bf16):
    from fpyv_tpu_torch.world.generators import render_edge_bank

    env = AcroEnv(params=DroneParams(att_mode="quat"), max_episode_steps=3)
    rig = default_vision_rig()
    worlds, pos, quat = render_edge_bank(n, rig, device=cuda_device)
    cols = torch.zeros(n, pk.ROWS, device=cuda_device)
    cols[:, 0:3] = torch.from_numpy(pos).to(cuda_device)
    cols[:, 6:10] = torch.from_numpy(quat).to(cuda_device)
    w = _edge_net(cuda_device, bf16)
    cfg = vk.RenderConfig.for_world(worlds, 25.0, include, extent)
    wcol = pk.policy_world_cols(worlds, n)
    out = pk.launch_policy_vision_rollout(env, rig, cols, wcol, cfg, w, 8, 5)
    torch.cuda.synchronize()
    ref = pk.policy_vision_rollout_reference(env, rig, cols, wcol, cfg, w, 8, 5,
                                             forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    assert (frames[0, 0] > 0).all()  # premise: env 0's camera inside sphere 0
    assert torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])
    assert torch.equal(state[:, 14:16], ref[3][:, 14:16])
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 4], ref[2][..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("ground,K,n,bf16", [
    pytest.param(True, 2, 13, False, id="ground-K2-13-f32"),
    pytest.param(False, 3, 64, False, id="no_ground-K3-64-f32"),
    pytest.param(True, 4, 64, True, id="ground-K4-64-bf16"),
    pytest.param(False, 1, 13, True, id="no_ground-K1-13-bf16")])
def test_cuda_k8_edge_worlds(cuda_device, ground, K, n, bf16):
    from fpyv_tpu_torch.world.generators import race_edge_start

    venv, world, cols, hist, _ = _race_setup(cuda_device, n, K, 3, 3, False)
    world, pos = race_edge_start(world, n, venv.rig, venv.race.obstacle_period)
    world = world.replace(has_ground=torch.tensor(ground, device=cuda_device))
    cols[:, 0:3], cols[:, 3:6], cols[:, 10:13] = torch.from_numpy(pos).to(cuda_device), 0.0, 0.0
    cols[:, 6:10] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=cuda_device)
    w = _edge_net(cuda_device, bf16, proprio=11, K=K)
    wcol, ocol = _race_inputs(venv, world)
    out = rk.launch_race_vision_rollout(venv, cols, hist, wcol, ocol, w, 8, 5)
    torch.cuda.synchronize()
    ref = rk.race_vision_rollout_reference(venv, cols, hist, wcol, ocol, w, 8, 5,
                                           forced_actions=out[2][..., :4] if bf16 else None)
    frames, extra, aux, state = out
    # premise: env 0's camera starts inside obstacle 0, which fills its view
    assert (frames[0, 0].reshape(108, K, 64)[:, -1] > 0).all()
    assert torch.equal(frames, ref[0]) and torch.equal(aux[..., 5], ref[2][..., 5])
    for c in (14, 15, 16, 19, 21):
        assert torch.equal(state[:, c], ref[3][:, c]), c
    mean_tol, value_tol = _heads_tol(bf16)
    torch.testing.assert_close(extra, ref[1], atol=1e-6, rtol=0)
    torch.testing.assert_close(aux[..., :4], ref[2][..., :4], atol=mean_tol, rtol=0)
    torch.testing.assert_close(aux[..., 4], ref[2][..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(aux[..., 6], ref[2][..., 6], atol=value_tol, rtol=0)
    torch.testing.assert_close(state, ref[3], atol=1e-3, rtol=0)


@pytest.mark.cuda
def test_state_net_on_the_card_matches_the_cpu(cuda_device):
    """ActorCritic (train_acro's and train_race's net) on the card against
    the same weights on the CPU over a 4096-env reset's observations:
    float32 with TF32 off, within 1e-5."""
    from fpyv_tpu_torch.models.policy import ActorCritic

    assert not torch.backends.cuda.matmul.allow_tf32
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    _, obs = env.reset(torch.Generator().manual_seed(3), env.default_world("cpu"), (4096,))
    net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, device="cpu").init_params(
        torch.Generator().manual_seed(4))
    card = ActorCritic(action_dim=4, obs_dim=env.obs_dim, device=cuda_device)
    card.load_state_dict(net.state_dict())
    with torch.no_grad():
        ref, out = net(obs), card(obs.to(cuda_device))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    assert ref[2].abs().max() > 1e-2  # premise: the value head is not all zero


def _pixel_net_pair(device, torso, gru, bf16, hw=(72, 96), proprio=5):
    from fpyv_tpu_torch.models.policy import PixelActorCritic

    kw = dict(action_dim=4, n_patches=(hw[0] // 8) * (hw[1] // 8), proprio_dim=proprio,
              torso=torso, gru=gru, image_hw=hw,
              compute_dtype=torch.bfloat16 if bf16 else None)
    net = PixelActorCritic(device="cpu", **kw).init_params(torch.Generator().manual_seed(5))
    card = PixelActorCritic(device=device, **kw)
    card.load_state_dict(net.state_dict())
    return net, card


def _bf16_layers_teacher_forced(net, card, args, device):
    """Each bf16 layer of the card's net fed the CPU net's own input to it:
    its outputs within one bf16 step at the layer's largest output (2^-8 of
    it) of the CPU's and at most 1 % of them off; the float32 tail (the
    GRU, the heads) fed the CPU's features within 1e-5."""
    from fpyv_tpu_torch.models import policy as tpolicy

    calls, names = [], {id(m): n for n, m in net.named_modules()}
    real_dense, real_conv = tpolicy.dense, tpolicy.F.conv2d

    def dense_rec(layer, x, dtype):
        out = real_dense(layer, x, dtype)
        if dtype is not None:
            name = names[id(layer)]
            calls.append((lambda xc: real_dense(card.get_submodule(name), xc, dtype), x, out))
        return out

    def conv_rec(x, w, **kw):
        out = real_conv(x, w, **kw)
        calls.append((lambda xc: real_conv(xc, w.to(device), **kw), x, out))
        return out

    tpolicy.dense, tpolicy.F.conv2d = dense_rec, conv_rec
    try:
        with torch.no_grad():
            feats = net.features(*args[:2])
    finally:
        tpolicy.dense, tpolicy.F.conv2d = real_dense, real_conv
    assert len(calls) >= 2
    with torch.no_grad(), card.numerics():
        for run, x, out in calls:
            got, ref = run(x.to(device)).cpu().float(), out.float()
            d = (got - ref).abs()
            assert d.max() <= 2.0 ** -8 * ref.abs().max() and (d > 0).float().mean() <= 1e-2
        tail = card.heads(feats.to(device), *(a.to(device) for a in args[2:]))
        for a, b in zip(tail, net.heads(feats, *args[2:])):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("torso,gru,bf16", [("conv", 0, False), ("conv", 0, True),
                                            ("patch", 128, False), ("patch", 128, True),
                                            ("conv", 128, False)])
def test_pixel_nets_on_the_card_match_the_cpu(cuda_device, torso, gru, bf16):
    """The conv net (train_vision's round-2 recipe) and the GRU net (the
    race's recurrent recipe, GRU-128) on the card against the same weights
    on the CPU over 256 frames of 96x72 levels, cuBLAS's bf16
    reduced-precision reductions and cuDNN's TF32 off inside the net and as
    they were after: float32 end to end within 1e-5; bf16 teacher-forced
    layer by layer. (End to end, one fc0 unit a bf16 step away, which the
    libraries' other sum order gives about 1 in 5000 units, moves the
    untrained policy mean by ~1e-3 of its largest value through pi_mean's
    0.01-scale weights, so the CPU tests' bf16 tolerance does not hold there
    on the card.)"""
    proprio = 11 if gru else 5
    net, card = _pixel_net_pair(cuda_device, torso, gru, bf16, proprio=proprio)
    g = torch.Generator().manual_seed(6)
    px = torch.randint(0, 256, (256, 72, 96), generator=g, dtype=torch.uint8)
    pr = torch.randn(256, proprio, generator=g)
    args = [px, pr] + ([torch.randn(256, gru, generator=g)] if gru else [])
    flags = (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
             torch.backends.cudnn.allow_tf32)
    with torch.no_grad():
        ref = net(*args)
        out = card(*(a.to(cuda_device) for a in args))
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cudnn.allow_tf32) == flags
    assert all(torch.isfinite(o).all() for o in out)
    if bf16:
        _bf16_layers_teacher_forced(net, card, args, cuda_device)
    else:
        for a, b in zip(out, ref):
            torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    assert ref[2].abs().max() > 1e-2  # premise: the value head is not all zero


def race_frames(device, n_races=64, n_agents=4, steps=5):
    """The 4-agent race with 3 obstacles, a few steps from a reset: K5's
    inputs for every agent's camera (the others and the obstacles as
    per-camera spheres)."""
    from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
    from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv

    venv = VisionRaceEnv(race=MultiRaceEnv(n_agents=n_agents, n_obstacles=3,
                                           max_episode_steps=2000))
    world = venv.default_world(device)
    g = torch.Generator().manual_seed(8)
    st, _ = venv.reset_batched(g, world, n_races)
    act = torch.zeros(n_races * n_agents, 4, device=device)
    act[:, 3] = -0.3
    for _ in range(steps):
        st, *_ = venv.step_batched(st, act, world, generator=g)
    cam_pos, cam_R, rworld, include = venv.render_scene(st, world)
    return venv, vk.render_inputs(venv.rig, cam_pos, cam_R, rworld, venv.max_depth, include,
                                  None, venv.frame_width)


@pytest.mark.cuda
def test_cuda_k5_renders_the_four_agent_race(cuda_device):
    venv, (cfg, dcam, cam, wcol) = race_frames(cuda_device)
    assert cfg.n_spheres == 3 + 3  # 3 opponents and 3 obstacles a camera
    out = vk.launch_render_depth(cfg, dcam, cam, wcol)
    torch.cuda.synchronize()
    ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert (ref > 0).float().mean() > 0.05  # premise: the track is in view


@pytest.mark.cuda
def test_cuda_scan_trainers_launch_k5_a_step(cuda_device):
    """train_vision on the scan rollout (conv torso) and the GRU race
    trainer at 2 agents: K5 once an env step and the bootstrap aside
    nothing else (K7 and K8 at 0), finite rewards."""
    from fpyv_tpu_torch.apps.train import train_vision, train_vision_race

    for train, kw in ((train_vision, dict(rollout="scan", torso="conv")),
                      (train_vision_race, dict(n_agents=2, gru=16))):
        _build.reset_launch_counts()
        res = train(num_envs=64, num_iterations=2, num_steps=8, scan_chunk=1, print_every=0,
                    **kw)
        assert _build.launch_counts["render_depth"] >= 2 * 8
        assert _build.launch_counts["policy_vision_rollout"] == 0
        assert _build.launch_counts["race_vision_rollout"] == 0
        assert np.isfinite(res.mean_reward_last)


@pytest.mark.cuda
def test_sac_nets_and_update_on_the_card_match_the_cpu(cuda_device, monkeypatch):
    """The SAC actor and twin critic, and one train step with one update, on
    the card against the same weights, replay and draws on the CPU (the
    draws fed through ``rl.replay.replay_indices`` and ``rl.sac.squash_noise``,
    a fixed env transition; float32, TF32 off): forward within 1e-5, the
    losses, alpha and entropy within 1e-6 + 1e-5 relative, every parameter
    and log_alpha within 1e-6 + 1e-4 relative."""
    from fpyv_tpu_torch.models.policy import SquashedGaussianActor, TwinQNetwork
    from fpyv_tpu_torch.rl import replay as rp
    from fpyv_tpu_torch.rl import sac as rs

    assert not torch.backends.cuda.matmul.allow_tf32
    n, batch, pre_n, O = 256, 512, 4096, 17
    g = torch.Generator().manual_seed(5)
    actor = SquashedGaussianActor(4, O, device="cpu").init_params(g)
    critic = TwinQNetwork(O, 4, device="cpu").init_params(g)
    obs = torch.randn(n, O, generator=g)
    pre = (torch.randn(pre_n, O, generator=g), 2.0 * torch.rand(pre_n, 4, generator=g) - 1.0,
           torch.randn(pre_n, generator=g), torch.randn(pre_n, O, generator=g),
           torch.rand(pre_n, generator=g) < 0.05)
    step_out = (obs + 0.01 * torch.randn(obs.shape, generator=g), torch.randn(n, generator=g),
                torch.rand(n, generator=g) < 0.05)
    idx = torch.randint(0, pre_n + n, (batch,), generator=g)
    noises = (torch.randn(n, 4, generator=g), torch.randn(batch, 4, generator=g),
              torch.randn(batch, 4, generator=g))

    def run(device):
        a, c = SquashedGaussianActor(4, O, device=device), TwinQNetwork(O, 4, device=device)
        a.load_state_dict(actor.state_dict())
        c.load_state_dict(critic.state_dict())
        nxt, rew, done = (x.to(device) for x in step_out)
        cfg = rs.SacConfig(num_envs=n, buffer_capacity=8192, batch_size=batch)
        init, step = rs.make_sac(lambda st, act, gen: (st, nxt, rew, done), cfg, O, 4)
        state = init(a, c, None, obs.to(device), torch.Generator(device=device))
        state = state.replace(buffer=rp.replay_add_batch(state.buffer,
                                                         *(x.to(device) for x in pre)))
        queue = list(noises)
        monkeypatch.setattr(rs, "squash_noise", lambda s, gen, dt, d: queue.pop(0).to(d))
        monkeypatch.setattr(rp, "replay_indices", lambda b, h, gen, d: idx.to(d))
        with torch.no_grad():
            fwd = (*a(obs.to(device)), *c(obs.to(device), pre[1][:n].to(device)))
        state, metrics = step(state)
        assert not queue
        params = [v.detach().cpu() for m in (state.actor, state.critic, state.target_critic)
                  for v in m.state_dict().values()] + [state.log_alpha.detach().cpu()]
        return [x.cpu() for x in fwd], {k: v.item() for k, v in metrics.items()}, params

    cpu_fwd, cpu_m, cpu_p = run(torch.device("cpu"))
    card_fwd, card_m, card_p = run(cuda_device)
    for x, y in zip(card_fwd, cpu_fwd):
        torch.testing.assert_close(x, y, atol=1e-5, rtol=0)
    for k, v in cpu_m.items():
        assert abs(card_m[k] - v) <= 1e-6 + 1e-5 * abs(v), k
    for x, y in zip(card_p, cpu_p):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-4)
    assert cpu_p[-1].abs().item() > 1e-4  # premise: the update moved the temperature


@pytest.mark.cuda
def test_cuda_sac_and_es_trainers_launch_no_kernel(cuda_device):
    """A short train_sac and train_es (acro and rotate) on the card: finite
    results, the tensors on the card, and no kernel launched (their JAX
    counterparts reach no pallas_call)."""
    from fpyv_tpu_torch.apps.train import make_sac_trainer, train_es, train_sac

    _build.reset_launch_counts()
    res = [train_sac(num_envs=64, num_iterations=4, warmup_steps=2, buffer_capacity=4096,
                     batch_size=128, scan_chunk=2, print_every=0)]
    for env_name in ("acro", "rotate"):
        res.append(train_es(env_name=env_name, num_envs=16, num_iterations=2, num_steps=8,
                            n_perturbations=4, scan_chunk=1, print_every=0))
    assert not any(_build.launch_counts.values())
    assert all(np.isfinite(r.mean_reward_last) for r in res)
    state = make_sac_trainer(num_envs=8, buffer_capacity=64, batch_size=16).state
    assert state.buffer.obs.is_cuda and state.last_obs.is_cuda and state.generator.device.type == "cuda"


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_replay_one_process(cuda_device):
    """Two gloo ranks sharing the card (``parallel.launch``) step their
    halves of a 256-env acro bank (episodes of 10 steps) and of 16
    two-agent races with fixed actions: rewards, positions, done flags and
    gate counters equal one process's bit for bit."""
    import torch_dist_ranks as ranks
    from fpyv_tpu_torch.parallel.launch import launch

    def joined(outs):
        return [np.concatenate([o[i] for o in outs], axis=1) for i in range(len(outs[0]))]

    for fn, args in ((ranks.acro_layout, (256, 32, 10)), (ranks.race_layout, (16, 2, 20))):
        one = fn(None, *args, device="cuda")
        two = joined(launch(fn, 2, args + ("cuda",), device="cuda:0", backend="gloo",
                            deadline=240.0))
        for a, b in zip(one, two):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_cuda_k5_renders_play_video_frames(cuda_device):
    """K5 at play's video shape, one camera at 640x480 (``_video_rig``), on
    the params.yaml world from an acro bank's drones: levels equal to its
    plain version, one launch a frame."""
    from fpyv_tpu_torch.apps.play import _video_rig, video_frame
    from fpyv_tpu_torch.envs.base import tree_map_tensors
    from fpyv_tpu_torch.physics.drone import _att_to_rotmat
    from fpyv_tpu_torch.vision.camera import camera_pose
    from fpyv_tpu_torch.vision.raycast import ALL

    rig = _video_rig((640, 480))
    env = AcroEnv(params=DroneParams(att_mode="quat"))
    st, _ = env.reset(torch.Generator().manual_seed(0), env.default_world(cuda_device), (4,))
    world = build_world(WorldSpec.from_config(SimulatorConfig(), seed=0), device=cuda_device)
    for i in range(4):
        drone = tree_map_tensors(lambda x, i=i: x[i], st.drone)
        _build.reset_launch_counts()
        frame = video_frame(rig, env.params, drone, world)
        assert _build.launch_counts["render_depth"] == 1
        cam_pos, cam_R = camera_pose(rig, drone.pos, _att_to_rotmat(env.params, drone.att))
        cfg, dcam, cam, wcol = vk.render_inputs(rig, cam_pos, cam_R, world, 25.0, ALL, None, 0.08)
        ref = vk.render_depth_reference(cfg, dcam, cam, wcol)
        assert frame.shape == (480, 640) and frame.dtype == torch.uint8
        torch.testing.assert_close(frame, torch.round(ref * 255.0).to(torch.uint8).reshape(480, 640),
                                   atol=0, rtol=0)


@pytest.mark.cuda
def test_run_simulator_on_the_card_matches_the_cpu(cuda_device):
    """The simulator (eager PyTorch, the splat renderer: no kernel) on the
    card against the CPU: params.yaml's world, 600 scripted steps (the crash
    at step 84 inside the first chunk), same steps and crash, the final state
    within tests/test_torch_simulator.py's TOL_CRASH; the 2d frames a frame
    every other step, the first within tests/test_torch_vision.py's 0.5 %."""
    from fpyv_tpu_torch.apps.simulator import run_simulator

    _build.reset_launch_counts()
    card, host = run_simulator(steps=600), run_simulator(steps=600, device="cpu")
    assert (card["steps"], card["crashed"]) == (host["steps"], host["crashed"]) == (84, True)
    for k, tol in {"final_position": 1e-4, "final_velocity": 1e-3}.items():
        np.testing.assert_allclose(card[k], host[k], rtol=0, atol=tol, err_msg=k)
    frames, first = [], []
    out = run_simulator(steps=40, render="2d", frame_sink=frames.append, seed=4)
    run_simulator(steps=1, render="2d", frame_sink=first.append, seed=4, device="cpu")
    assert out["steps"] == 40 and len(frames) == 20
    assert (frames[0] != first[0]).mean() <= 0.005
    assert not any(_build.launch_counts.values())


@pytest.mark.cuda
def test_sensor_acro_and_hover_on_the_card_match_the_cpu(cuda_device):
    """``SensorAcroEnv`` (64 envs, 8 steps) and the hover env with its pilot
    (64 envs, 60 closed-loop steps) from the same CPU generator's draws on
    the card and on the CPU: no kernel launched."""
    from fpyv_tpu_torch.envs.hover import HoverEnv, HoverPilot
    from fpyv_tpu_torch.envs.sensor_acro import SensorAcroEnv

    _build.reset_launch_counts()
    runs = []  # the card's, then the CPU's
    for dev in (cuda_device, torch.device("cpu")):
        env, g = SensorAcroEnv(), torch.Generator().manual_seed(0)
        world = env.acro.default_world(dev)
        st, obs = env.reset(g, world, (64,))
        act = torch.zeros(64, 4, device=dev)
        act[:, 3] = -0.6
        for _ in range(8):
            st, obs, *_ = env.step(st, act, world, generator=g)
        henv, pilot, g = HoverEnv(), HoverPilot(drone_params=DroneParams()), torch.Generator()
        hs, _ = henv.reset(g.manual_seed(1), (64,), dev)
        ps, hworld = pilot.init((64,), device=dev), henv.default_world(dev)
        for _ in range(60):
            ps, a = pilot.act(ps, hs.drone, hs.target_pos)
            hs, *_ = henv.step(hs, a, hworld, generator=g)
        runs.append((obs.cpu(), hs.drone.pos.cpu()))
    np.testing.assert_allclose(runs[0][0], runs[1][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(runs[0][1], runs[1][1], atol=1e-4, rtol=0)
    assert not any(_build.launch_counts.values())


@pytest.mark.cuda
def test_geometry_and_nn_on_the_card_match_the_cpu(cuda_device):
    """The geometry algorithms in float64 and the float32 nets (TF32 off)
    on the card against the CPU."""
    from fpyv_tpu_torch.models import nn
    from fpyv_tpu_torch.models.terrain import terrain_heightmap
    from fpyv_tpu_torch.vision import geometry as geo

    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (30, 3)) + np.array([0, 0, 8.0])
    P1 = np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = np.hstack([np.eye(3), np.array([[1.0], [0.2], [0.1]])])
    h = lambda P: (P @ np.hstack([X, np.ones((30, 1))]).T).T
    p1, p2 = h(P1)[:, :2] / h(P1)[:, 2:], h(P2)[:, :2] / h(P2)[:, 2:]
    anchors = rng.normal(size=(6, 3)) * 5
    ranges = np.linalg.norm(anchors - rng.normal(size=3), axis=1)
    src = rng.uniform(-1, 1, (80, 2))
    dst = src @ np.array([[0.99, -0.12], [0.12, 0.99]]).T + 0.1
    q, k, v = (rng.normal(size=(2, 64, 32)).astype(np.float32) for _ in range(3))
    out = []  # the card's, then the CPU's
    for dev in (cuda_device, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(dev)
        F = geo.eight_point(t(p1), t(p2))
        F = F * torch.sign(F[2, 2])
        out.append([F, geo.triangulate(t(P1), t(P2), t(p1), t(p2)),
                         geo.trilaterate_gauss_newton(t(anchors), t(ranges)),
                         *geo.icp_2d(t(src), t(dst), 20),
                         *nn.attention(t(q), t(k), t(v)),
                         terrain_heightmap(torch.Generator().manual_seed(0), device=dev)[1]])
    for i, (a, b) in enumerate(zip(*out)):
        a, b = a.cpu(), b
        tol = 1e-9 if a.dtype == torch.float64 else 1e-5 * b.abs().max().item()
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=0, err_msg=str(i))
