"""The render of K7 and K8 on edge worlds: their plain PyTorch versions
against ``pallas_policy_vision_rollout`` and ``pallas_race_vision_rollout``
in interpret mode, where the render's early exits decide pixels.

``world.generators.render_edge_bank`` gives K7 one env a case (the camera
inside sphere 0; an inactive sphere and cylinder; a cylinder whose height
band holds the camera and an open tube around it; the camera looking down
two coaxial tubes; a gate edge-on to the camera and a ring behind it; the
camera on the ground plane; a ring and a half-circle gate; an open view),
with the ground unclipped, clipped and left out of the render.
``world.generators.race_edge_start`` gives K8's track an edge-on gate and a
gate behind a camera and starts cameras inside an obstacle and on its
orbit, with the ground on and off. The card's kernels are held against the
same plain versions on these worlds in tests/test_torch_cuda.py.

Set-up: a 16x16 rig (4 patches), 8 envs (one Pallas block), 3 steps of
2-step episodes, float32 weights from a Flax init. Tolerances as
tests/test_torch_policy_kernel.py (K7: frames, crash flags, done and t
equal; proprio 1e-6, actions and value 5e-5, reward 1e-5, log_prob 1e-4)
and tests/test_torch_race_kernel.py (K8: frames equal but for one level on
at most 0.1 % of them, an obstacle centre's cos/sin an ulp apart between
XLA and PyTorch; flags and counters equal, the rest within 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.acro import AcroEnv as JEnv
from fpyv_tpu.envs.multi_race import MultiRaceEnv as JRace
from fpyv_tpu.envs.vision_race import VisionRaceEnv as JVRace
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.ops import pallas_policy as jpp
from fpyv_tpu.ops import pallas_race as jpr
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.physics.world import World as JWorld
from fpyv_tpu.vision.camera import CameraRig as JRig
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.envs.acro import AcroEnv as TEnv
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv as TRace
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv as TVRace
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.ops import policy_kernel as tpk
from fpyv_tpu_torch.ops import race_kernel as trk
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.vision.camera import CameraRig as TRig
from fpyv_tpu_torch.world.generators import EDGE_CASES, render_edge_bank, race_edge_start

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(16, 16))  # HW = 256, 4 patches
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)
N, T, NP, MAX_STEPS = 8, 3, 4, 2
MAX_DEPTH, FRAME_WIDTH = 12.0, 0.08


def _jax_world(tworld):
    return JWorld(**{k: jnp.asarray(v) for k, v in interop.to_numpy_tree(tworld).items()})


def _nets(proprio, kp, seed=2):
    jnet = JNet(action_dim=4, torso="patch", prepatched=True, compute_dtype=None)
    params = jnet.init(jax.random.key(seed), jnp.zeros((1, NP, kp), jnp.float32),
                       jnp.zeros((1, proprio), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    p = params["params"]  # a std that samples, a mean head that steers
    p["log_std"] = np.full_like(p["log_std"], -0.3)
    p["pi_mean"]["kernel"] = p["pi_mean"]["kernel"] * 30.0
    tnet = TNet(action_dim=4, n_patches=NP, proprio_dim=proprio, torso="patch",
                prepatched=True, frame_stack=kp // 64, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    return params, tnet


@pytest.mark.parametrize("ground_extent,include", [
    (None, tpk.INCLUDE), (4.0, tpk.INCLUDE), (None, ("spheres", "cylinders", "gates"))],
    ids=["ground", "clipped", "no_ground"])
def test_k7_plain_matches_pallas_on_edge_worlds(ground_extent, include):
    tworld, pos, quat = render_edge_bank(N, TRIG, device="cpu")
    cols = np.zeros((N, tpk.ROWS), np.float32)
    cols[:, 0:3], cols[:, 6:10] = pos, quat
    cols[:, 16] = np.linalg.norm(pos - interop.to_numpy_tree(tworld)["sphere_center"][:, 0], axis=1)
    jenv = JEnv(params=JP(att_mode="quat"), max_episode_steps=MAX_STEPS, dtype=jnp.float32)
    tenv = TEnv(params=TP(att_mode="quat"), max_episode_steps=MAX_STEPS)
    params, tnet = _nets(5, 64)
    w = jpp.build_policy_weights(params, n_patches=NP, compute_dtype=None)
    fr, ex, ax, co = (np.asarray(x) for x in jpp.pallas_policy_vision_rollout(
        jenv, JRIG, jnp.asarray(cols), _jax_world(tworld), w, T, 7, MAX_DEPTH, include=include,
        ground_extent=ground_extent, frame_width=FRAME_WIDTH, e_blk=8, compute_dtype=None,
        interpret=True))
    frames, extra, aux, out = tpk.fused_policy_vision_rollout(
        tenv, TRIG, torch.from_numpy(cols), tworld, tpk.build_policy_weights(tnet, None), T, 7,
        MAX_DEPTH, include=include, ground_extent=ground_extent, frame_width=FRAME_WIDTH)
    # premise: the camera inside sphere 0 sees it at every pixel
    assert EDGE_CASES[0] == "inside_sphere" and (fr[0, 0] > 0).all()
    np.testing.assert_array_equal(frames.numpy(), fr.astype(np.uint8))
    np.testing.assert_array_equal(aux[..., 5].numpy(), ax[..., 5])  # crash flags
    np.testing.assert_array_equal(out[:, 14:16].numpy(), co[:, 14:16])  # done, t
    np.testing.assert_allclose(extra.numpy(), ex, atol=1e-6, rtol=0)
    np.testing.assert_allclose(aux[..., :4].numpy(), ax[..., :4], atol=5e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 4].numpy(), ax[..., 4], atol=1e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 6].numpy(), ax[..., 6], atol=5e-5, rtol=0)
    np.testing.assert_allclose(aux[..., 7].numpy(), ax[..., 7], atol=1e-4, rtol=0)


@pytest.mark.parametrize("ground", [True, False], ids=["ground", "no_ground"])
def test_k8_plain_matches_pallas_on_edge_worlds(ground):
    K, S, G = 2, 2, 6
    race_kw = dict(n_agents=1, gate_size=5.0, max_episode_steps=MAX_STEPS, n_obstacles=S)
    jvenv = JVRace(race=JRace(params=JP(att_mode="quat"), **race_kw), rig=JRIG, frame_stack=K)
    tvenv = TVRace(race=TRace(params=TP(att_mode="quat"), **race_kw), rig=TRIG, frame_stack=K)
    tworld, pos = race_edge_start(tvenv.default_world("cpu"), N, TRIG,
                                  tvenv.race.obstacle_period)
    tworld = tworld.replace(has_ground=torch.tensor(ground))
    jworld = _jax_world(tworld)
    states = jax.vmap(lambda k: jvenv.race.reset(k, jworld)[0])(
        jax.random.split(jax.random.key(0), N))
    cols = np.array(jpr.race_state_to_cols(states))
    cols[:, 0:3], cols[:, 3:6], cols[:, 10:13] = pos, 0.0, 0.0
    cols[:, 6:10] = [1.0, 0.0, 0.0, 0.0]
    hist = np.random.default_rng(0).integers(0, 256, (N, NP * (K - 1) * 64)).astype(np.uint8)
    params, tnet = _nets(5 + G, K * 64)
    w = jpp.build_policy_weights(params, n_patches=NP, compute_dtype=None)
    ref = [np.asarray(x, np.float32) for x in jpr.pallas_race_vision_rollout(
        jvenv, jnp.asarray(cols), jnp.asarray(hist, jnp.bfloat16), jworld, w, T, 7, e_blk=8,
        compute_dtype=None, interpret=True)]
    out = trk.fused_race_vision_rollout(tvenv, torch.from_numpy(cols), torch.from_numpy(hist),
                                        tworld, tpk.build_policy_weights(tnet, None), T, 7)
    frames, extra, aux, st = (x.float().numpy() for x in out)
    fr, ex, ax, co = ref
    # premise: env 0's camera starts inside obstacle 0, which fills its view
    assert (fr[0, 0].reshape(NP, K, 64)[:, -1] > 0).all()
    diff = np.abs(frames - fr)
    assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_array_equal(aux[..., 5], ax[..., 5])  # env ends
    for c in (14, 15, 16, 19, 21):  # crashed, t, next_gate, gates_passed, flush
        np.testing.assert_array_equal(st[:, c], co[:, c], err_msg=f"state column {c}")
    np.testing.assert_allclose(extra, ex, atol=1e-5, rtol=0)
    for j in (0, 1, 2, 3, 4, 6, 7):
        np.testing.assert_allclose(aux[..., j], ax[..., j], atol=1e-5, rtol=0)
    for rows, tol in ((slice(0, 10), 1e-5), (slice(10, 14), 1e-3), (slice(17, 18), 1e-5),
                      (slice(18, 19), 1e-3), (slice(20, 21), 1e-5)):
        np.testing.assert_allclose(st[:, rows], co[:, rows], atol=tol, rtol=0)
