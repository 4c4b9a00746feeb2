"""The port's CUDA kernels K2/K3/K4 against their plain PyTorch versions on
the card. Imports neither JAX nor ``fpyv_tpu``, so it runs where only the
port is installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX). Every test needs a
CUDA device and skips without one: the kernels have no CPU or interpret mode.

Tolerances: the kernels are built with --fmad=false and without fast math,
so they round as the plain versions do and differ by libm ulps at most
(sinf/cosf/logf on the card against PyTorch's own CUDA kernels): 1e-5 after
one step, 1e-4 after 64 chained steps, 1e-3 on 64-step reward sums. The step
counter t, and with it every reset decision, is equal exactly.
"""

import pytest
import torch

from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import env_kernel as ek
from fpyv_tpu_torch.ops import step_kernel as sk
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.world.generators import WorldSpec, build_world


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _bank(device, world="default", n=256, **kw):
    env = AcroEnv(params=DroneParams(att_mode="quat"), **kw)
    if world == "default":
        w = env.default_world(device)
    else:
        w = build_world(WorldSpec.from_config(SimulatorConfig(), seed=2), device=device)
    g = torch.Generator().manual_seed(0)
    st, _ = env.reset(g, w, (n,))
    act = torch.zeros(n, 4, device=device)
    act[:, 3] = -0.6
    return env, w, st, act


@pytest.mark.cuda
@pytest.mark.parametrize("world", ["default", "params"])
def test_cuda_k2_k3_match_plain(cuda_device, world):
    env, w, st, act = _bank(cuda_device, world)
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
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("world,kw", [("default", dict(max_episode_steps=20)),
                                      ("params", dict(max_episode_steps=20, randomize=True,
                                                      wind=(1.0, 0.5, 0.0), wind_scale=0.5))])
def test_cuda_k4_matches_plain_across_resets(cuda_device, world, kw):
    env, w, st, act = _bank(cuda_device, world, **kw)
    s, a = ek.env_state_to_matrix(st), sk.action_matrix(act)
    wm = ek.env_world_matrix(w)
    cyl = sk.cylinder_matrix(w) if sk.world_has_cylinders(w) else None
    out, rsum = ek.launch_env_rollout(env, s, a, wm, 64, seed=3, cyl_mat=cyl)
    torch.cuda.synchronize()
    ref, ref_rsum, resets = ek.env_rollout_reference(env, s, a, wm, 64, seed=3, cyl_mat=cyl)
    assert resets > 0
    torch.testing.assert_close(out[15], ref[15], atol=0, rtol=0)  # t: resets equal
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(rsum, ref_rsum, atol=1e-3, rtol=0)


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
    assert _build.launch_counts == {"drone_step": 1, "rollout": 1, "env_rollout": 1}
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
