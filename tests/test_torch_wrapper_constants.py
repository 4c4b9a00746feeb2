"""The K7/K8 rollout wrappers' device constants, made once per rig, net and
device instead of once a call: the patch-major ray grid
(``policy_kernel.device_patch_dcam``), the tensor-core fragment index
(``policy_kernel._fragment_index``), the camera mount
(``vision.camera.device_mount``) and the bootstrap proprio's divisors
(``policy_kernel.proprio_divisors``). Each equals its per-call construction
bit for bit, is the same object on a second call with the same key and a
new one for another key; ``camera_pose`` gives what it gave before;
``device.divisor`` still makes a new tensor a call; and the K8 and K7
``rollout_fn`` give the same outputs over two threaded calls whether the
caches are warm or cleared before each call. On the card (``-m cuda``,
skips here), a second ``rollout_fn`` call counts no host-device sync under
its ``rollout`` span and equals the same call made with the caches cleared.
Imports neither JAX nor ``fpyv_tpu``:

    python -m pytest --noconftest -q tests/test_torch_wrapper_constants.py
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fpyv_tpu_torch.apps.train import make_vision_race_trainer, make_vision_trainer
from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv
from fpyv_tpu_torch.ops import policy_kernel as pk
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.ops import vision_kernel as vk
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.utils import profiling
from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose, device_mount

CPU = torch.device("cpu")
META = torch.device("meta")  # a second device on a machine without a card
RIG = CameraRig(resolution=(16, 8))
MOUNTED = CameraRig(pitch_deg=20.0, rel_position=(0.1, -0.05, 0.02), fov_deg=100.0,
                    resolution=(24, 16))
CACHES = (pk.device_patch_dcam, pk._fragment_index, pk.proprio_divisors, device_mount,
          vk.device_dcam)


def clear_caches():
    for cache in CACHES:
        cache.cache_clear()


def _old_fragment_index():
    """The index as built at every call before it was cached."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], dim=1)
    cols = torch.stack([2 * t, 2 * t + 1, 2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9, 2 * t + 8,
                        2 * t + 9], dim=1)
    return rows, cols


def _equal(a, b):
    return a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)


# ---------------------------------------------------------------------------
# Each constant: its per-call value, made once a key
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rig", [RIG, MOUNTED, CameraRig(resolution=(96, 72))],
                         ids=["16x8", "24x16", "96x72"])
def test_device_patch_dcam_is_the_per_call_grid_made_once(rig):
    grid = pk.device_patch_dcam(rig, CPU)
    assert _equal(grid, torch.from_numpy(pk.patch_major_ray_grid(rig)))
    assert grid.dtype == torch.float32 and grid.shape == (3, rig.resolution[0] * rig.resolution[1])
    assert pk.device_patch_dcam(rig, CPU) is grid
    other = CameraRig(pitch_deg=rig.pitch_deg, fov_deg=rig.fov_deg + 1.0,
                      resolution=rig.resolution)
    assert pk.device_patch_dcam(other, CPU) is not grid
    assert not torch.equal(pk.device_patch_dcam(other, CPU), grid)
    on_meta = pk.device_patch_dcam(rig, META)
    assert on_meta is not grid and on_meta.device.type == "meta" and on_meta.shape == grid.shape


def test_the_fragment_index_is_the_per_call_index_made_once_a_device():
    rows, cols = pk._fragment_index(CPU)
    old_rows, old_cols = _old_fragment_index()
    assert _equal(rows, old_rows) and _equal(cols, old_cols)
    assert all(a is b for a, b in zip(pk._fragment_index(CPU), (rows, cols)))
    meta = pk._fragment_index(META)
    assert all(m.device.type == "meta" and m is not c for m, c in zip(meta, (rows, cols)))


def test_fragment_order_reads_the_cached_index_and_keeps_its_values():
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    rows, cols = _old_fragment_index()
    a = w.reshape(4, 16, 2, 16).permute(2, 0, 3, 1)
    want = a[:, :, rows, cols].contiguous()
    assert torch.equal(pk.fragment_order_fc(w), want)
    clear_caches()
    assert torch.equal(pk.fragment_order_fc(w), want)
    assert torch.equal(pk.fc_from_fragment_order(want), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("rig", [RIG, MOUNTED], ids=["default_mount", "mounted"])
def test_the_camera_mount_is_the_per_call_mount_made_once(rig, dtype):
    rel_p, rel_R = device_mount(rig, CPU, dtype)
    assert _equal(rel_p, torch.as_tensor(rig.rel_position, dtype=dtype))
    assert _equal(rel_R, torch.as_tensor(rig.mount_rotation, dtype=dtype))
    again = device_mount(rig, CPU, dtype)
    assert again[0] is rel_p and again[1] is rel_R
    other_dtype = torch.float64 if dtype == torch.float32 else torch.float32
    assert device_mount(rig, CPU, other_dtype)[1] is not rel_R
    other_rig = CameraRig(pitch_deg=rig.pitch_deg + 5.0, rel_position=rig.rel_position,
                          resolution=rig.resolution)
    assert device_mount(other_rig, CPU, dtype)[1] is not rel_R
    assert device_mount(rig, META, dtype)[0].device.type == "meta"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_camera_pose_with_a_nonzero_mount_is_unchanged(dtype):
    g = torch.Generator().manual_seed(5)
    pos = torch.randn(7, 3, generator=g, dtype=dtype) * 10.0
    quat = torch.nn.functional.normalize(torch.randn(7, 4, generator=g, dtype=dtype), dim=-1)
    R = rot.quat_to_rotmat(quat)
    kw = dict(dtype=dtype, device=CPU)
    want_p = pos + rot.mat3_vec(R, torch.as_tensor(MOUNTED.rel_position, **kw))
    want_R = rot.mat3_mul(R, torch.as_tensor(MOUNTED.mount_rotation, **kw))
    for _ in range(2):  # a cold cache, then a warm one
        cam_pos, cam_R = camera_pose(MOUNTED, pos, R)
        assert torch.equal(cam_pos, want_p) and torch.equal(cam_R, want_R)
    assert float(torch.linalg.vector_norm(cam_pos - pos, dim=-1).min()) > 0.05
    one_p, one_R = camera_pose(MOUNTED, pos[3], R[3])  # unbatched
    assert torch.equal(one_p, want_p[3]) and torch.equal(one_R, want_R[3])
    cam_pos.add_(1.0)  # an output is the caller's own: the cached mount is untouched
    assert _equal(device_mount(MOUNTED, CPU, dtype)[0], torch.as_tensor(MOUNTED.rel_position,
                                                                         **kw))


def test_the_proprio_divisors_are_divisor_made_once_a_device():
    like, params = torch.zeros(3), DroneParams(att_mode="quat")
    divs = pk.proprio_divisors(params, CPU)
    want = (float(params.max_rates), 30.0, float(params.thrust_curve.max_force))
    for d, x in zip(divs, want):
        assert _equal(d, divisor(x, like)) and d.shape == ()
    assert pk.proprio_divisors(DroneParams(att_mode="quat"), CPU) is divs  # an equal drone
    other = pk.proprio_divisors(DroneParams(att_mode="quat", max_rates=300.0), CPU)
    assert other is not divs and float(other[0]) == 300.0 and torch.equal(other[2], divs[2])
    assert pk.proprio_divisors(params, META) is not divs
    x = torch.randn(64, 3, generator=torch.Generator().manual_seed(1)) * 300.0
    assert torch.equal(x / divs[0], x / divisor(want[0], x))


def test_device_divisor_stays_a_new_tensor_a_call():
    """Its other callers pass values that change every step (Adam's bias
    corrections), so it is not cached."""
    like = torch.zeros(2)
    a, b = divisor(0.5, like), divisor(0.5, like)
    assert a is not b and torch.equal(a, b)
    assert float(divisor(0.25, like)) == 0.25


# ---------------------------------------------------------------------------
# The rollout_fns: warm caches against cleared ones, and K7's one ground check
# ---------------------------------------------------------------------------


def _race(device, n=4, steps=4, rig=RIG):
    return make_vision_race_trainer(num_envs=n, num_steps=steps, seed=3, frame_stack=2,
                                    n_obstacles=1, rig=rig, rollout="kernel", device=device)


def _chase(device, n=4, steps=4, rig=RIG):
    return make_vision_trainer(num_envs=n, num_steps=steps, seed=3, rig=rig, rollout="kernel",
                               device=device)


def _flat(out):
    """(name, tensor) of a rollout_fn's carry, bootstrap obs and trajectory."""
    carry, obs, traj = out
    items = [("carry", c) for c in (carry if isinstance(carry, tuple) else (carry,))]
    items += [(f"obs.{k}", v) for k, v in obs.items()]
    items += [(f"traj.obs.{k}", v) for k, v in traj.obs.items()]
    items += [(f"traj.{k}", getattr(traj, k))
              for k in ("action", "log_prob", "value", "reward", "done")]
    return items


def _calls(trainer, n, cold):
    st, outs = trainer.state, []
    for _ in range(n):
        if cold:
            clear_caches()
        out = trainer.rollout_fn(st)
        st = st.replace(env_state=out[0], last_obs=out[1])
        outs.append(out)
    return outs


@pytest.mark.parametrize("make", [_race, _chase], ids=["k8", "k7"])
def test_two_threaded_calls_equal_those_with_the_caches_cleared(make):
    warm = _calls(make(CPU), 2, cold=False)
    cold = _calls(make(CPU), 2, cold=True)
    for w, c in zip(warm, cold):
        for (name, a), (_, b) in zip(_flat(w), _flat(c)):
            assert _equal(a, b), name


def test_the_k7_rollout_fn_checks_the_fixed_worlds_once(monkeypatch):
    """The ground check runs where the parts are made; the rollout_fn still
    launches through ``fused_policy_vision_rollout`` (looked up at each
    call, so a wrapper put in its place sees every launch) but hands it the
    prepared worlds, so ``world.has_ground`` is not read again; without
    them the wrapper checks, for its other callers."""
    trainer = _chase(CPU)
    calls, launches = [], []
    real, fused = pk.policy_rollout_supported, pk.fused_policy_vision_rollout
    monkeypatch.setattr(pk, "policy_rollout_supported",
                        lambda env, worlds: calls.append(1) or real(env, worlds))
    monkeypatch.setattr(pk, "fused_policy_vision_rollout",
                        lambda *a, **kw: launches.append(a[6]) or fused(*a, **kw))
    st = trainer.state
    for _ in range(2):
        carry, obs, _ = trainer.rollout_fn(st)
        st = st.replace(env_state=carry, last_obs=obs)
    assert calls == [] and len(launches) == 2
    venv = VisionAcroEnv(acro=AcroEnv(params=DroneParams(att_mode="quat")), rig=RIG)
    world, _ = venv.make_world(device=CPU)
    no_ground = world.replace(has_ground=torch.zeros_like(world.has_ground))
    env = venv.acro
    w = pk.build_policy_weights(trainer.state.params, None)
    with pytest.raises(ValueError, match="over ground"):
        fused(env, RIG, st.env_state, no_ground, w, 1, 0, 25.0)
    assert calls == [1]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("make", [_race, _chase], ids=["k8", "k7"])
def test_cuda_a_second_rollout_call_syncs_nothing_and_equals_a_cold_one(make):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    dev = torch.device("cuda")
    warm, cold = (make(dev, n=64, steps=8, rig=CameraRig(resolution=(96, 72)))
                  for _ in range(2))
    states = []
    for trainer in (warm, cold):
        carry, obs, _ = trainer.rollout_fn(trainer.state)
        states.append(trainer.state.replace(env_state=carry, last_obs=obs))
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out_warm = warm.rollout_fn(states[0])
    recs = profiling.spans()
    (root,) = [r for r in recs if r.name == "rollout"]
    assert [r.name for r in recs if r.parent == root.index][:2] == ["rollout.weights",
                                                                   "rollout.launch"]
    assert [(r.name, r.syncs) for r in recs if r.root == root.index and r.syncs] == []
    profiling.clear_spans()
    clear_caches()
    out_cold = cold.rollout_fn(states[1])
    torch.cuda.synchronize()
    for (name, a), (_, b) in zip(_flat(out_warm), _flat(out_cold)):
        assert _equal(a, b), name
    frames = out_warm[2].obs["pixels"]
    assert frames.dtype == torch.uint8 and bool((frames > 0).any())
    assert np.isfinite(out_warm[2].reward.cpu().numpy()).all()
