"""K7, the policy-in-kernel vision rollout: its plain PyTorch version against
``pallas_policy_vision_rollout(..., interpret=True)``, the layouts and
weights it takes, the PPO parts around it, and the pixel trainer on the CPU.
The CUDA kernel against its plain version is in tests/test_torch_cuda.py.

Set-up as tests/test_pallas_policy.py: a 32x24 rig, 16 envs in per-env
``sample_worlds`` with 2 cylinders, weights carried from a Flax init, a
non-zero action std, and 4-step episodes so every env resets inside the
6-step rollout. The murmur3 draws match bit for bit, so the comparison holds
across resets.

Tolerances: frames, crash flags and the step counter t are equal. float32
weights: proprio 1e-6, actions and value 5e-5, reward 1e-5, log_prob 1e-4
(the float32 products are summed in another order); bf16 weights round to
bf16 after those sums, where a hidden unit can land one bf16 step away: value
1e-3, proprio 1e-5, the rest as float32. Final state: position, velocity and
prev_dist 1e-5, quaternion 1e-6, rates (deg/s), thrust (N) and accel_z
(m/s^2) 1e-3.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.envs.vision_acro import VisionAcroEnv as JVision
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.ops import pallas_policy as jpp
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.vision.camera import CameraRig as JRig
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps.train import train_vision
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv as TVision
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import policy_kernel as tpk
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.rl.ppo import PpoConfig, make_ppo
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint
from fpyv_tpu_torch.vision.camera import CameraRig as TRig

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(32, 24))  # HW = 768, 12 patches
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)
N, T, NP = 16, 6, 12
MAX_STEPS = 4


def _setup(pool=1, bf16=False, seed=0, hidden=(256,), n_motors=4):
    jenv = JEnv(params=JP(att_mode="quat", n_motors=n_motors), max_episode_steps=MAX_STEPS,
                dtype=jnp.float32)
    jvenv = JVision(acro=jenv, rig=JRIG, renderer="raycast", target_only=False, pixel_dtype="u8")
    worlds, bank = jvenv.make_randomized_worlds(jax.random.key(seed), N, n_cylinders=2)
    state, _ = jvenv.reset_batched(jax.random.split(jax.random.key(seed + 1), N), worlds, bank)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jnet = JNet(action_dim=4, torso="patch", prepatched=True, compute_dtype=jdt, patch_pool=pool,
                hidden=hidden)
    params = jnet.init(jax.random.key(seed + 2), jnp.zeros((1, NP, 64), jnp.float32),
                       jnp.zeros((1, 5), jnp.float32))
    tnet = TNet(action_dim=4, n_patches=NP, torso="patch", prepatched=True, compute_dtype=tdt,
                patch_pool=pool, hidden=hidden, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(jax.tree.map(np.asarray, params),
                                                          "cpu"))
    tenv = TEnv(params=TP(att_mode="quat", n_motors=n_motors), max_episode_steps=MAX_STEPS)
    tvenv = TVision(acro=tenv, rig=TRIG, renderer="raycast", target_only=False, pixel_dtype="u8")
    tworlds = interop.world_from_numpy(interop.to_numpy_tree(worlds), "cpu")
    cols = jpp.acro_state_to_cols(state)
    return dict(jenv=jenv, jvenv=jvenv, worlds=worlds, state=state, jnet=jnet, params=params,
                tnet=tnet, tenv=tenv, tvenv=tvenv, tworlds=tworlds, cols=cols,
                tcols=torch.from_numpy(np.array(cols)), jdt=jdt, tdt=tdt)


STATE_TOL = [(slice(0, 6), 1e-5), (slice(6, 10), 1e-6), (slice(10, 13), 1e-3),
             (slice(13, 14), 1e-3), (slice(16, 17), 1e-5), (slice(17, 18), 1e-3)]


@pytest.mark.parametrize("pool,bf16", [(1, False), (1, True), (4, False)])
def test_k7_plain_matches_pallas_across_resets(pool, bf16):
    _check_k7(_setup(pool, bf16), pool, bf16)


# Any fc width (one hidden layer, as the Pallas kernel's support matrix) and
# any motor count: 384 units pass the 256 threads of a block, 200 is no
# multiple of the bf16 kernel's 16-row tiles (build_policy_weights pads it).
@pytest.mark.parametrize("hidden,bf16", [(384, False), (384, True), (200, True)])
def test_k7_plain_matches_pallas_wide_fc_hexacopter(hidden, bf16):
    s = _setup(1, bf16, hidden=(hidden,), n_motors=6)
    _check_k7(s, 1, bf16)


def test_bf16_zero_padding_gives_the_unpadded_heads_exactly():
    """hidden = 200 in bf16: 8 zero units (fc columns, bias and head rows)
    round the width up to 208; the padded actor's heads equal the unpadded
    one's bit for bit."""
    s = _setup(1, True, hidden=(200,))
    w = tpk.build_policy_weights(s["tnet"], torch.bfloat16)
    assert w.wf.shape[1] == w.bf.shape[1] == w.wm.shape[0] == 208
    assert w.wf_tc.shape[0] == 13  # 16-row tiles
    assert not w.wf[:, 200:].any() and not w.bf[:, 200:].any() and not w.wm[200:].any()
    unpadded = tpk.PolicyWeights(we=w.we, be=w.be, wp=w.wp, bp=w.bp, wf=w.wf[:, :200].contiguous(),
                                 bf=w.bf[:, :200].contiguous(), wm=w.wm[:200].contiguous(),
                                 bm=w.bm, std=w.std)
    rng = np.random.default_rng(3)
    levels = torch.from_numpy(rng.integers(0, 256, (32, NP * 64)).astype(np.float32))
    prop = list(torch.from_numpy(rng.normal(size=(5, 32)).astype(np.float32)))
    a = tpk.policy_forward_reference(w, levels, prop, 1)
    b = tpk.policy_forward_reference(unpadded, levels, prop, 1)
    assert a.abs().max() > 0
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def _check_k7(s, pool, bf16):
    w = jpp.build_policy_weights(s["params"], n_patches=NP, compute_dtype=s["jdt"],
                                 patch_pool=pool)
    fr, ex, ax, co = jpp.pallas_policy_vision_rollout(
        s["jenv"], JRIG, s["cols"], s["worlds"], w, T, 7, s["jvenv"].max_depth,
        frame_width=s["jvenv"].frame_width, e_blk=8, compute_dtype=s["jdt"], patch_pool=pool,
        interpret=True)
    tw = tpk.build_policy_weights(s["tnet"], s["tdt"])
    assert float(tw.std[0, 0]) > 0.5  # premise: the actions are sampled, not the mean
    before = dict(_build.launch_counts)
    frames, extra, aux, cols = tpk.fused_policy_vision_rollout(
        s["tenv"], TRIG, s["tcols"], s["tworlds"], tw, T, 7, s["tvenv"].max_depth,
        frame_width=s["tvenv"].frame_width, patch_pool=pool)
    assert _build.launch_counts == before  # the CPU path launches no kernel
    assert frames.dtype == torch.uint8 and frames.shape == (T, N, 768)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(fr).astype(np.uint8))
    ax, co = np.asarray(ax), np.asarray(co)
    np.testing.assert_array_equal(aux[..., 5].numpy(), ax[..., 5])  # crash flags
    np.testing.assert_array_equal(cols[:, 14:16].numpy(), co[:, 14:16])  # done, t
    assert (co[:, 15] < T).all()  # premise: every env reset inside the rollout
    np.testing.assert_allclose(extra.numpy(), np.asarray(ex), atol=1e-5 if bf16 else 1e-6,
                               rtol=0)
    np.testing.assert_allclose(aux[..., :4].numpy(), ax[..., :4], atol=5e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 4].numpy(), ax[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 6].numpy(), ax[..., 6], atol=1e-3 if bf16 else 5e-5,
                               rtol=0)
    np.testing.assert_allclose(aux[..., 7].numpy(), ax[..., 7], atol=1e-4, rtol=0)
    for rows, tol in STATE_TOL:
        np.testing.assert_allclose(cols[:, rows].numpy(), co[:, rows], atol=tol, rtol=0)


@pytest.mark.parametrize("pool,bf16", [(1, False), (4, True)])
def test_policy_weights_match_pallas(pool, bf16):
    s = _setup(pool, bf16)
    ref = jpp.build_policy_weights(s["params"], n_patches=NP, compute_dtype=s["jdt"],
                                   patch_pool=pool)
    out = tpk.build_policy_weights(s["tnet"], s["tdt"])
    for name in ref._fields:
        a = getattr(out, name)
        assert not a.requires_grad
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(getattr(ref, name),
                                                                    np.float32), err_msg=name)


def test_layouts_match_pallas():
    s = _setup()
    np.testing.assert_array_equal(tpk.patch_major_ray_grid(TRIG), jpp.patch_major_ray_grid(JRIG))
    img = np.random.default_rng(0).integers(0, 256, size=(3, 24, 32)).astype(np.uint8)
    np.testing.assert_array_equal(tpk.prepatch_pixels(torch.from_numpy(img)).numpy(),
                                  np.asarray(jpp.prepatch_pixels(jnp.asarray(img))))
    tstate = interop.acro_state_from_numpy(interop.to_numpy_tree(s["state"]), "cpu")
    cols = tpk.acro_state_to_cols(tstate)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(s["cols"]))
    back = tpk.cols_to_acro_state(cols, tstate)
    np.testing.assert_array_equal(tpk.acro_state_to_cols(back).numpy(), cols.numpy())


def test_obs_from_cols_matches_pallas_parts():
    """The bootstrap observation: K5's frame as uint8 levels, patch-major,
    and the proprio by true division."""
    s = _setup()
    _, _, jobs = jpp.make_kernel_vision_ppo_parts(s["jvenv"], s["worlds"], s["jnet"], N, e_blk=8,
                                                  interpret=True)
    _, _, tobs = tpk.make_kernel_vision_ppo_parts(s["tvenv"], s["tworlds"], s["tnet"], N)
    ref, out = jobs(s["cols"]), tobs(s["tcols"])
    assert out["pixels"].dtype == torch.uint8
    np.testing.assert_array_equal(out["pixels"].numpy(), np.asarray(ref["pixels"]))
    np.testing.assert_allclose(out["proprio"].numpy(), np.asarray(ref["proprio"]), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("exact_logprob", [True, False])
def test_kernel_ppo_iteration(exact_logprob):
    """One PPO iteration through the K7 rollout_fn. With the learner's own
    recompute (exact_logprob) the first minibatch of the first epoch sees a
    ratio of exactly 1: approx_kl is 0.0. (T*N = 64 rows is one shuffle
    block, so the minibatch holds the rows in the rollout's order.)"""
    s = _setup()
    apply_fn, make_rollout_fn, obs_from_cols = tpk.make_kernel_vision_ppo_parts(
        s["tvenv"], s["tworlds"], s["tnet"], N)
    cfg = PpoConfig(num_envs=N, num_steps=4, update_epochs=1, num_minibatches=1)
    init, iteration = make_ppo(apply_fn, None, cfg,
                               rollout_fn=make_rollout_fn(4, compute_dtype=None,
                                                          exact_logprob=exact_logprob))
    st = init(s["tnet"], s["tcols"], obs_from_cols(s["tcols"]), torch.Generator().manual_seed(0))
    st2, info = iteration(st)
    assert all(np.isfinite(v.item()) for v in info.values())
    assert st2.env_state.shape == (N, 18) and st2.update_count == 1
    if exact_logprob:
        assert info["approx_kl"].item() == 0.0
    else:  # the kernel's own log-probs: the same weights, another summation order
        assert abs(info["approx_kl"].item()) < 1e-4


def test_launch_refuses_cpu_tensors():
    s = _setup()
    cfg = tpk.RenderConfig.for_world(s["tworlds"], 25.0)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.launch_policy_vision_rollout(
            s["tenv"], TRIG, s["tcols"], tpk.policy_world_cols(s["tworlds"], N), cfg,
            tpk.build_policy_weights(s["tnet"], None), 2, 0)


def _train(tmp_path, name, iterations, resume=False, log=False, randomize_worlds=True):
    return train_vision(num_envs=N, num_iterations=iterations, num_steps=4, seed=3, rig=TRIG,
                        scan_chunk=1, num_minibatches=2, update_epochs=1, compute_dtype="f32",
                        checkpoint_dir=str(tmp_path / name), checkpoint_every=2, resume=resume,
                        log_dir=str(tmp_path / "log") if log else None, print_every=0,
                        randomize_worlds=randomize_worlds, device="cpu")


@pytest.mark.parametrize("randomize_worlds", [True, False])  # per-env worlds, params.yaml's
def test_train_vision_cpu_smoke(tmp_path, randomize_worlds):
    res = _train(tmp_path, "ck", 3, log=True, randomize_worlds=randomize_worlds)
    assert res.iterations == 3
    assert np.isfinite(res.mean_reward_first) and np.isfinite(res.mean_reward_last)
    rows = [json.loads(ln) for ln in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["mean_reward"]) for r in rows)


def test_checkpoint_resume_matches_unbroken_run(tmp_path):
    """4 iterations in one run against 2 + a resume for 2 more: the step-4
    checkpoints (params, Adam, env matrix, last obs, generator) are equal."""
    _train(tmp_path, "whole", 4)
    _train(tmp_path, "split", 2)
    _train(tmp_path, "split", 2, resume=True)
    a = restore_checkpoint(str(tmp_path / "whole"), 4)
    b = restore_checkpoint(str(tmp_path / "split"), 4)
    assert a["update_count"] == b["update_count"] == 4
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) > 10
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    c = restore_checkpoint(str(tmp_path / "split"), 2)
    assert not torch.equal(c["env_state"], b["env_state"])  # premise: the runs moved


# the scan rollout's options run in tests/test_torch_scan_trainers.py
@pytest.mark.parametrize("kw", [dict(distributed=True, rollout="kernel")])
def test_train_vision_kernel_refuses_distributed(kw):
    """JAX's own refusal: K7 bakes the worlds into its columns and runs on
    one device (fpyv_tpu/apps/train.py:909-911); ``auto`` routes
    ``distributed`` to the scan rollout."""
    with pytest.raises(ValueError, match="does not compose with distributed"):
        train_vision(num_envs=8, num_iterations=1, device="cpu", **kw)
