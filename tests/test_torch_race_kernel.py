"""K8, the policy-in-kernel vision race rollout: its plain PyTorch version
against ``pallas_race_vision_rollout(..., interpret=True)``, the layouts it
takes and the PPO parts around it (the trainer is in tests/test_torch_race.py).
The CUDA kernel against its plain version is in tests/test_torch_cuda.py.

Set-up as tests/test_pallas_race.py: the 32x24 rig (12 patches), 16 envs on
the default 6-gate track, weights carried from a Flax init with a sampling
std and a mean head that steers, and 4-step episodes so every env resets
(respawn, flush) inside the 6-step rollout. The murmur3 draws match bit for
bit, so the comparison holds across resets.

Tolerances: crash flags (aux column 5), ``next_gate``, ``gates_passed``, t
and the flush flag are equal; frames (the stacks) equal but for one level on
at most 0.1 % of the levels (an obstacle centre's cos/sin may differ by an
ulp between XLA and PyTorch); state, proprio, actions, reward, value and
log-prob within 1e-5 (float32 weights: the products are summed in another
order) or 1e-3 for the value and 2e-4 for the actions in bf16 (a hidden unit
can land one bf16 step away); rates (deg/s), thrust (N) and accel_z (m/s^2)
within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.multi_race import MultiRaceEnv as JRace
from fpyv_tpu.envs.vision_race import VisionRaceEnv as JVRace
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.ops import pallas_policy as jpp
from fpyv_tpu.ops import pallas_race as jpr
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.vision.camera import CameraRig as JRig
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv as TRace
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv as TVRace
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops import policy_kernel as tpk
from fpyv_tpu_torch.ops import race_kernel as trk
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.rl.ppo import PpoConfig, make_ppo
from fpyv_tpu_torch.vision.camera import CameraRig as TRig

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(32, 24))  # HW = 768, 12 patches
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)
N, T, NP, G = 16, 6, 12, 6


def _setup(K=1, onehot=True, S=0, bf16=False, max_steps=4, seed=0, pool=1, hidden=(256,),
           n_motors=4):
    race_kw = dict(n_agents=1, gate_size=5.0, max_episode_steps=max_steps, n_obstacles=S)
    jvenv = JVRace(race=JRace(params=JP(att_mode="quat", n_motors=n_motors), **race_kw),
                   rig=JRIG, gate_onehot=onehot, frame_stack=K)
    tvenv = TVRace(race=TRace(params=TP(att_mode="quat", n_motors=n_motors), **race_kw),
                   rig=TRIG, gate_onehot=onehot, frame_stack=K)
    world = jvenv.default_world()
    tworld = interop.world_from_numpy(interop.to_numpy_tree(world), "cpu")
    states = jax.vmap(lambda k: jvenv.race.reset(k, world)[0])(
        jax.random.split(jax.random.key(seed), N))
    cols = jpr.race_state_to_cols(states)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jnet = JNet(action_dim=4, torso="patch", prepatched=True, compute_dtype=jdt, patch_pool=pool,
                hidden=hidden)
    params = jnet.init(jax.random.key(seed + 2), jnp.zeros((1, NP, K * 64), jnp.float32),
                       jnp.zeros((1, 5 + G), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    p = params["params"]  # a std that samples, a mean head that steers
    p["log_std"] = np.full_like(p["log_std"], -0.3)
    p["pi_mean"]["kernel"] = p["pi_mean"]["kernel"] * 30.0
    tnet = TNet(action_dim=4, n_patches=NP, proprio_dim=5 + G, torso="patch", prepatched=True,
                compute_dtype=tdt, patch_pool=pool, frame_stack=K, hidden=hidden, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    return dict(jvenv=jvenv, tvenv=tvenv, world=world, tworld=tworld, states=states, cols=cols,
                tcols=torch.from_numpy(np.array(cols)), jnet=jnet, params=params, tnet=tnet,
                jdt=jdt, tdt=tdt, K=K, pool=pool)


def _hist(s, seed=0):
    """A random (N, NP*(K-1)*64) history of levels: the stacks' older slots
    at the first step, so their shift shows."""
    K = s["K"]
    h = np.random.default_rng(seed).integers(0, 256, size=(N, NP * (K - 1) * 64)).astype(np.uint8)
    jh = jnp.asarray(h, jnp.bfloat16) if K > 1 else jnp.zeros((N, 8), jnp.bfloat16)
    return jh, torch.from_numpy(h)


def _pallas(s, jhist, cols=None, steps=T, seed=7):
    w = jpp.build_policy_weights(s["params"], n_patches=NP, compute_dtype=s["jdt"],
                                 patch_pool=s["pool"])
    out = jpr.pallas_race_vision_rollout(
        s["jvenv"], s["cols"] if cols is None else cols, jhist, s["world"], w, steps, seed,
        e_blk=8, compute_dtype=s["jdt"], patch_pool=s["pool"], interpret=True)
    return [np.asarray(x, np.float32) for x in out]


def _assert_matches(out, ref, bf16):
    frames, extra, aux, cols = (x.float().numpy() for x in out)
    fr, ex, ax, co = ref
    diff = np.abs(frames - fr)
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_array_equal(aux[..., 5], ax[..., 5])  # env ends
    for c in (14, 15, 16, 19, 21):  # crashed, t, next_gate, gates_passed, flush
        np.testing.assert_array_equal(cols[:, c], co[:, c], err_msg=f"state column {c}")
    np.testing.assert_allclose(extra, ex, atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., :4], ax[..., :4], atol=2e-4 if bf16 else 1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 4], ax[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 6], ax[..., 6], atol=1e-3 if bf16 else 1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 7], ax[..., 7], atol=1e-5, rtol=0)
    for rows, tol in ((slice(0, 10), 1e-5), (slice(10, 14), 1e-3), (slice(17, 18), 1e-5),
                      (slice(18, 19), 1e-3), (slice(20, 21), 1e-5)):
        np.testing.assert_allclose(cols[:, rows], co[:, rows], atol=tol, rtol=0)


@pytest.mark.parametrize("K,onehot,S,bf16,pool", [
    (1, True, 0, False, 1),  # one frame, the track alone
    (2, False, 3, False, 1),  # pixels + IMU, obstacles
    (3, True, 3, False, 1),
    (4, True, 0, True, 1),  # the bench recipe's stack in bf16
    (2, True, 0, False, 4),  # the pooled mixer
])
def test_k8_plain_matches_pallas_across_resets(K, onehot, S, bf16, pool):
    _check_k8(_setup(K, onehot, S, bf16, pool=pool), bf16)


# Any fc width and motor count, as the Pallas kernel takes them, on the
# set-ups of the float32 case with obstacles and of the bf16 case above:
# 384 units pass the 256 threads of a block, 200 is no multiple of the bf16
# kernel's 16-row tiles (build_policy_weights pads it).
@pytest.mark.parametrize("hidden,bf16", [(384, False), (384, True), (200, True)])
def test_k8_plain_matches_pallas_wide_fc_hexacopter(hidden, bf16):
    K, onehot, S = (4, True, 0) if bf16 else (2, False, 3)
    _check_k8(_setup(K, onehot, S, bf16, hidden=(hidden,), n_motors=6), bf16)


def _check_k8(s, bf16):
    K, pool = s["K"], s["pool"]
    jh, th = _hist(s)
    ref = _pallas(s, jh)
    w = tpk.build_policy_weights(s["tnet"], s["tdt"])
    before = dict(_build.launch_counts)
    out = trk.fused_race_vision_rollout(s["tvenv"], s["tcols"], th, s["tworld"], w, T, 7,
                                        patch_pool=pool)
    assert _build.launch_counts == before  # the CPU path launches no kernel
    assert out[0].dtype == torch.uint8 and out[0].shape == (T, N, NP * K * 64)
    assert (ref[2][..., 5].sum(0) > 0).all()  # premise: every env's episode ended
    assert ref[2][..., :4].std() > 0.1  # premise: the actions are sampled and steer
    _assert_matches(out, ref, bf16)


def test_k8_plain_matches_pallas_gate_passing_and_crash():
    """Drones placed just behind gate 0 flying through it, others on the
    ground: gates pass (counter, next gate, the w_gate bonus), crashes
    respawn on the ring with the flush flag set."""
    s = _setup(K=2, S=0, max_steps=50)  # obstacle 0 starts at gate 0
    cols = np.array(s["cols"])
    cols[:8, 0], cols[:8, 1], cols[:8, 2] = 12.0, -0.05, 3.0  # gate 0: (12, 0, 3), normal +y
    cols[:8, 3:6] = [0.0, 12.0, 0.5]
    cols[:8, 20] = -0.05  # the signed plane distance the crossing needs
    cols[8:, 2], cols[8:, 5] = 0.05, -6.0  # falling into the ground
    jh, th = _hist(s)
    ref = _pallas(s, jh, cols=jnp.asarray(cols), steps=3)
    w = tpk.build_policy_weights(s["tnet"], None)
    out = trk.fused_race_vision_rollout(s["tvenv"], torch.from_numpy(cols), th, s["tworld"], w,
                                        3, 7)
    assert (ref[3][:8, 19] >= 1).all() and (ref[2][..., 4] > 5).any()  # premise: gates passed
    assert ref[2][:, 8:, 5].any(axis=0).all()  # premise: the grounded envs crashed
    _assert_matches(out, ref, False)


def test_layouts_match_pallas():
    s = _setup(K=3, S=3)
    np.testing.assert_array_equal(trk.race_world_cols(s["tworld"]).numpy()[0],
                                  np.asarray(jpr._world_cols(
                                      jpr._RenderCfg(hw=768, width=32, n_spheres=0, n_cylinders=0,
                                                     n_gates=G, spheres=False, cylinders=False,
                                                     ground=True, gates=True, max_depth=40.0,
                                                     ground_extent=None), s["world"], 1))[0])
    np.testing.assert_array_equal(trk.obstacle_cols(s["tworld"], 3).numpy(),
                                  np.asarray(jpr._obstacle_cols(s["world"], 1, 3)))
    np.testing.assert_array_equal(trk.obstacle_cols(s["tworld"], 0).numpy(), np.zeros((1, 8)))
    tstates = interop.race_state_from_numpy(interop.to_numpy_tree(s["states"]), "cpu")
    np.testing.assert_array_equal(trk.race_state_to_cols(tstates).numpy(), np.asarray(s["cols"]))
    # the kernel's obstacle formula against the env's, to an ulp
    t = torch.arange(0, 1300, 7, dtype=torch.float32)
    ocol = trk.obstacle_cols(s["tworld"], 3)
    ker = torch.stack([torch.stack(o[:3], -1) for o in trk.obstacles_at(ocol, 3, t)], 1)
    env = s["tvenv"].race._obstacles_at(s["tworld"], t.to(torch.int32))
    np.testing.assert_allclose(ker.numpy(), env.numpy(), atol=1e-5, rtol=0)


def test_policy_weights_match_pallas_frame_stacked():
    s = _setup(K=4, bf16=True)
    ref = jpp.build_policy_weights(s["params"], n_patches=NP, compute_dtype=jnp.bfloat16)
    out = tpk.build_policy_weights(s["tnet"], torch.bfloat16)
    assert out.we.shape == (4 * 64, 128) and out.wf.shape[0] == 1664
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(out, name).float().numpy(),
                                      np.asarray(getattr(ref, name), np.float32), err_msg=name)


def _ppo_parts(s, jax_side=False):
    if jax_side:
        return jpr.make_kernel_race_ppo_parts(s["jvenv"], s["world"], s["jnet"], N, e_blk=8,
                                              interpret=True)
    return trk.make_kernel_race_ppo_parts(s["tvenv"], s["tworld"], s["tnet"], N)


@pytest.mark.parametrize("K,S", [(1, 0), (3, 3)])
def test_carry_parts_match_pallas(K, S):
    """init_carry's layout and obs_from_carry's stack (K5's frame under the
    history, flushed where the flag is set) against the JAX parts."""
    s = _setup(K=K, S=S)
    _, _, jobs, jinit, jmetrics = _ppo_parts(s, jax_side=True)
    _, _, tobs, tinit, tmetrics = _ppo_parts(s)
    jcols, jhist = jinit(jax.random.split(jax.random.key(3), N))
    cols, hist = tinit(torch.Generator().manual_seed(3))
    assert cols.shape == (N, 22) and hist.dtype == torch.uint8
    assert hist.shape == (N, NP * (K - 1) * 64) and (cols[:, 21] == 0).all()
    # the history is the first frame repeated: the stack's slots are equal
    stack = tobs((cols, hist))["pixels"].reshape(N, NP, K, 64)
    assert (stack == stack[:, :, -1:]).all()
    # the same carry through both, a flush on half the envs
    jcols = np.array(jcols)
    jcols[::2, 21] = 1.0
    if K > 1:
        hist = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, size=(N, NP * (K - 1) * 64)).astype(np.uint8))
        jhist = jnp.asarray(hist.numpy())
    ref, out = jobs((jnp.asarray(jcols), jhist)), tobs((torch.from_numpy(jcols), hist))
    assert out["pixels"].dtype == torch.uint8
    np.testing.assert_array_equal(out["pixels"].numpy(), np.asarray(ref["pixels"]))
    np.testing.assert_allclose(out["proprio"].numpy(), np.asarray(ref["proprio"]), atol=1e-6,
                               rtol=0)
    for k, v in tmetrics((torch.from_numpy(jcols), hist)).items():
        np.testing.assert_allclose(v.item(), float(jmetrics((jnp.asarray(jcols), jhist))[k]),
                                   rtol=1e-6)


@pytest.mark.parametrize("exact_logprob", [True, False])
def test_kernel_race_ppo_iteration(exact_logprob):
    """One PPO iteration through the K8 rollout_fn. With the learner's own
    recompute the first minibatch of the first epoch sees a ratio of
    exactly 1 (T*N = 64 rows is one shuffle block, kept in order)."""
    s = _setup(K=2, S=3)
    apply_fn, make_rollout_fn, obs_from_carry, init_carry, metrics = _ppo_parts(s)
    cfg = PpoConfig(num_envs=N, num_steps=4, update_epochs=1, num_minibatches=1)
    init, iteration = make_ppo(apply_fn, None, cfg, metrics_fn=metrics,
                               rollout_fn=make_rollout_fn(4, compute_dtype=None,
                                                          exact_logprob=exact_logprob))
    carry = init_carry(torch.Generator().manual_seed(0))
    st = init(s["tnet"], carry, obs_from_carry(carry), torch.Generator().manual_seed(0))
    st2, info = iteration(st)
    assert all(np.isfinite(v.item()) for v in info.values())
    assert "mean_gates_passed" in info and st2.update_count == 1
    cols, hist = st2.env_state
    assert cols.shape == (N, 22) and hist.shape == (N, NP * 64)
    if exact_logprob:
        assert info["approx_kl"].item() == 0.0
    else:  # the kernel's own log-probs: the same weights, another summation order
        assert abs(info["approx_kl"].item()) < 1e-4


def test_launch_refuses_cpu_tensors_and_oversized_stacks():
    s = _setup(K=2)
    w = tpk.build_policy_weights(s["tnet"], None)
    _, th = _hist(s)
    with pytest.raises(ValueError, match="CUDA"):
        trk.launch_race_vision_rollout(s["tvenv"], s["tcols"], th,
                                       trk.race_world_cols(s["tworld"]),
                                       trk.obstacle_cols(s["tworld"], 0), w, 2, 0)
    # the stack's older frames stay in device memory: shared memory grows
    # with K by one patch group's stacks only
    fits = trk.race_shared_bytes(96 * 72, 4, 3, 6, 256, 1)
    assert fits < 80_000
    assert trk.race_shared_bytes(96 * 72, 4, 3, 6, 256, 1) - trk.race_shared_bytes(
        96 * 72, 1, 3, 6, 256, 1) == 8 * 3 * 64
    assert trk.race_shared_bytes(640 * 480, 1, 0, 6, 256, 1) > trk.SHARED_LIMIT
