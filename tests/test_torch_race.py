"""The race envs, the frame-stacked net and the race trainer of the port
against the JAX package: ``MultiRaceEnv`` (reset, step, obs, the shared-policy
adapter) at 1 and 4 agents, ``VisionRaceEnv`` (FPV views with opponents and
obstacles, the frame stack and its flush), the frame-stacked
``PixelActorCritic`` with carried Flax weights, the race-state interop, and
``train_vision_race`` on the CPU.

Both packages start from the same state (a JAX reset carried across through
``interop``) and step with the same actions (numpy, seeded). Their reset
draws differ (threefry keys against a ``torch.Generator``), so a race is
compared until its first reset; rewards, done flags and the step's info are
compared for every race (they come before the reset).

Tolerances: positions, velocities and distances 1e-5 (float32, another
order of the same operations), the quaternion 1e-6, rates (deg/s) and
thrust (N) 1e-4, accelerations 1e-4, rewards 1e-5; counters, flags, ranks and
next gates equal. Depth frames (uint8 levels, the K5 raycast against the JAX
raycast) equal but for one level on at most 0.1 % of the pixels. The net:
as tests/test_torch_policy.py (1e-6 in float32; 1e-3 of the largest output
in bf16).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.envs.multi_race import MultiRaceEnv as JRace
from fpyv_tpu.envs.multi_race import make_shared_policy_env_step as jshared
from fpyv_tpu.envs.vision_race import VisionRaceEnv as JVRace
from fpyv_tpu.envs.vision_race import VisionRaceState as JVState
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.vision.camera import CameraRig as JRig
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps.train import train_vision_race
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv as TRace
from fpyv_tpu_torch.envs.multi_race import make_shared_policy_env_step as tshared
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv as TVRace
from fpyv_tpu_torch.envs.vision_race import VisionRaceState
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint
from fpyv_tpu_torch.vision.camera import CameraRig as TRig

RIG_ARGS = dict(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                resolution=(32, 24))
JRIG, TRIG = JRig(**RIG_ARGS), TRig(**RIG_ARGS)
R = 8  # races

TOL = {"pos": 1e-5, "vel": 1e-5, "att": 1e-6, "rates": 1e-4, "thrust": 1e-4, "accel": 1e-4,
       "prev_gate_dist": 1e-5, "prev_center_dist": 1e-5, "episode_return": 1e-5}


def _envs(A, S=0, max_steps=2000, **kw):
    args = dict(n_agents=A, n_obstacles=S, max_episode_steps=max_steps, **kw)
    return JRace(**args), TRace(**args)


def _staged(jenv, seed=0):
    """R fresh races, then staged: race 0 has agent 0 just behind gate 1
    (no obstacle comes near it early on) flying through it; race 1 has
    agents 0 and 1 in contact (A > 1) or agent 0 under the ground; race 2
    is one step from its time limit; race 3 has every agent under the
    ground; with obstacles, race 4's agent 0 sits where obstacle 0 will be
    next step."""
    world = jenv.default_world()
    st = jax.vmap(lambda k: jenv.reset(k, world)[0])(jax.random.split(jax.random.key(seed), R))
    pos, vel = np.array(st.drones.pos), np.array(st.drones.vel)
    pgd, t, ng = np.array(st.prev_gate_dist), np.array(st.t), np.array(st.next_gate)
    gp, gn = np.asarray(world.gate_pos)[1], np.asarray(world.gate_rotmat)[1][:, 0]
    pos[0, 0], vel[0, 0], pgd[0, 0], ng[0, 0] = gp - 0.05 * gn, 12.0 * gn, -0.05, 1
    if jenv.n_agents > 1:
        pos[1, 1] = pos[1, 0] + np.array([0.2, 0.0, 0.0], np.float32)
    else:
        pos[1, 0, 2] = -0.01
    t[2] = jenv.max_episode_steps - 1
    pos[3, :, 2] = -0.01
    if jenv.n_obstacles:
        pos[4, 0] = np.asarray(jenv._obstacles_at(world, jnp.int32(1)))[0]
    st = st.replace(drones=st.drones.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel)),
                    prev_gate_dist=jnp.asarray(pgd), t=jnp.asarray(t), next_gate=jnp.asarray(ng))
    return world, st


def _carry(jstate, world):
    return (interop.race_state_from_numpy(interop.to_numpy_tree(jstate), "cpu"),
            interop.world_from_numpy(interop.to_numpy_tree(world), "cpu"))


def _assert_state(t, j, live):
    """Every field of the port's race state against the JAX one on the
    races in ``live``."""
    tn, jn = interop.race_state_to_numpy(t), interop.to_numpy_tree(j)
    for name, d in (("drones", tn["drones"]), *((k, v) for k, v in tn.items() if k != "drones")):
        pairs = d.items() if name == "drones" else [(name, d)]
        ref = jn["drones"] if name == "drones" else jn
        for f, v in pairs:
            a, b = np.asarray(v)[live], np.asarray(ref[f])[live]
            if f in TOL:
                np.testing.assert_allclose(a, b, atol=TOL[f], rtol=0, err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)


def _actions(seed, shape):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, size=shape).astype(np.float32)


@pytest.mark.parametrize("A,S", [(1, 0), (1, 3), (4, 3)])
def test_multi_race_step_matches_jax(A, S):
    """Three steps from the staged races: gate passing, agent contact,
    obstacle hits, crashes and the time limit, with the reset of every race
    whose agents all crashed or whose time ran out."""
    jenv, tenv = _envs(A, S, max_steps=60)
    world, jst = _staged(jenv)
    tst, tworld = _carry(jst, world)
    g = torch.Generator().manual_seed(0)
    j_obs = np.asarray(jax.vmap(lambda s: jenv._obs(s, world))(jst))
    np.testing.assert_allclose(tenv._obs(tst, tworld).numpy(), j_obs, atol=1e-5, rtol=0)
    alive = np.ones(R, bool)
    seen = {"passed": False, "contact": False, "done": False}
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, world)))
    for i in range(3):
        act = _actions(i, (R, A, 4))
        jst, jobs, jr, jd, jinfo = jstep(jst, jnp.asarray(act))
        tst, tobs, tr, td, tinfo = tenv.step(tst, torch.from_numpy(act), tworld, generator=g)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tr.numpy()[alive], np.asarray(jr)[alive], atol=1e-5, rtol=0)
        for k in ("gates_passed", "crashed", "contact", "overtakes"):
            np.testing.assert_array_equal(tinfo[k].numpy()[alive], np.asarray(jinfo[k])[alive],
                                          err_msg=k)
        seen["passed"] |= bool(np.asarray(jinfo["gates_passed"])[0, 0] > 0) and i == 0
        seen["contact"] |= bool(np.asarray(jinfo["contact"]).any())
        seen["done"] |= bool(np.asarray(jd).any())
        alive &= ~np.asarray(jd)
        _assert_state(tst, jst, alive)
        np.testing.assert_allclose(tobs.numpy()[alive], np.asarray(jobs)[alive], atol=1e-4, rtol=0)
    assert seen["passed"] and seen["done"]  # premises: a gate passed, races reset
    assert seen["contact"] == (A > 1)
    assert alive.sum() >= 3  # premise: some races ran all three steps
    # the reset races restart on the spawn ring, gate 0 next, at t = 0
    done0 = ~alive
    assert (tst.t.numpy()[done0] <= 2).all() and (tst.next_gate.numpy()[done0] == 0).all()


@pytest.mark.parametrize("A", [1, 4])
def test_shared_policy_env_step_matches_jax(A):
    jenv, tenv = _envs(A, 3, max_steps=60)
    world, jst = _staged(jenv)
    tst, tworld = _carry(jst, world)
    j_step, j_reset = jshared(jenv, world, n_envs=R)
    t_step, t_reset = tshared(tenv, tworld, n_envs=R)
    st0, obs0 = t_reset(torch.Generator().manual_seed(1))
    assert obs0.shape == (R * A, tenv.obs_dim) and st0.t.shape == (R,)
    act = _actions(5, (R * A, 4))
    jst2, jobs, jr, jd = j_step(jst, jnp.asarray(act), jax.random.key(0))
    tst2, tobs, tr, td = t_step(tst, torch.from_numpy(act), torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    live = ~np.asarray(jst2.t == 0)
    assert live.sum() >= 3 and (~live).sum() >= 1  # premise: some races reset
    np.testing.assert_allclose(tobs.numpy().reshape(R, A, -1)[live],
                               np.asarray(jobs).reshape(R, A, -1)[live], atol=1e-4, rtol=0)


def _frames_close(a, b):
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("A,S", [(1, 3), (2, 0)])
def test_vision_race_obs_matches_jax(A, S):
    """The FPV views (gates, ground, obstacles at episode time t, the other
    agents as spheres) and the IMU and one-hot blocks from the same state."""
    jr, tr = _envs(A, S)
    jv, tv = JVRace(race=jr, rig=JRIG), TVRace(race=tr, rig=TRIG)
    world, jst = _staged(jr)
    jst = jst.replace(t=jnp.arange(R, dtype=jnp.int32) * 37)  # obstacles along their orbit
    tst, tworld = _carry(jst, world)
    jobs, tobs = jv._obs(jst, world), tv._obs(tst, tworld)
    assert tobs["pixels"].dtype == torch.uint8 and tobs["pixels"].shape == (R, A, 24, 32)
    _frames_close(tobs["pixels"].numpy(), jobs["pixels"])
    assert (np.asarray(jobs["pixels"]) > 0).mean() > 0.05  # premise: the track is in view
    for k in ("rates", "accel_z", "thrust", "gate_onehot"):
        np.testing.assert_allclose(tobs[k].numpy(), np.asarray(jobs[k]), atol=1e-6, rtol=0,
                                   err_msg=k)


def test_vision_race_frame_stack_and_flush_match_jax():
    """frame_stack=3: reset gives the first frame three times; a step
    shifts the stack (newest last) where the race goes on and flushes it to
    the respawn frame where the race reset."""
    K = 3
    jr, tr = _envs(1, 3, max_steps=60)
    jv = JVRace(race=jr, rig=JRIG, frame_stack=K)
    tv = TVRace(race=tr, rig=TRIG, frame_stack=K)
    world, jst0 = _staged(jr)
    tst0, tworld = _carry(jst0, world)
    state, obs = tv.reset_batched(torch.Generator().manual_seed(0), tworld, R)
    assert isinstance(state, VisionRaceState) and obs["pixels"].shape == (R, K, 24, 32)
    assert state.frames.shape == (R, 1, K - 1, 24, 32)
    assert (obs["pixels"] == obs["pixels"][:, -1:]).all()
    # the same staged state with a random history through both
    hist = np.random.default_rng(0).integers(0, 256, size=(R, 1, K - 1, 24, 32)).astype(np.uint8)
    jst = JVState(race=jst0, frames=jnp.asarray(hist))
    tst = VisionRaceState(race=tst0, frames=torch.from_numpy(hist))
    act = _actions(3, (R, 4))
    jst, jobs, jrew, jd, jinfo = jv.step_batched(jst, jnp.asarray(act), world)
    tst, tobs, trew, td, tinfo = tv.step_batched(tst, torch.from_numpy(act), tworld,
                                                 generator=torch.Generator().manual_seed(1))
    done = np.asarray(jd)
    assert done.any() and (~done).sum() >= 3  # premise: both kinds of race
    np.testing.assert_array_equal(td.numpy(), done)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tinfo["crashed"].numpy(), np.asarray(jinfo["crashed"]))
    px = tobs["pixels"].numpy()
    _frames_close(px[~done], np.asarray(jobs["pixels"])[~done])
    np.testing.assert_array_equal(px[~done][:, :K - 1], hist[~done][:, 0])  # the shift
    assert (px[done] == px[done][:, -1:]).all()  # flushed to the respawn frame
    np.testing.assert_array_equal(tst.frames.numpy()[:, 0], px[:, 1:])


@pytest.mark.parametrize("K", [1, 2, 3])
@pytest.mark.parametrize("u8,bf16", [(False, False), (True, True)])
def test_frame_stacked_net_matches_flax(K, u8, bf16):
    """PixelActorCritic over a (B, K, H, W) stack, and prepatched (B, NP,
    K*64), against Flax with the same weights."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    rng = np.random.default_rng(K)
    lev = rng.integers(0, 256, size=(6, K, 24, 32)).astype(np.uint8)
    px = lev if u8 else lev.astype(np.float32) / np.float32(255.0)
    proprio = rng.normal(size=(6, 11)).astype(np.float32)
    jin = px if K > 1 else px[:, 0]
    for prepatched in (False, True):
        if prepatched:  # per-frame space-to-depth, a patch's frames concatenated
            jin = px.reshape(6, K, 3, 8, 4, 8).transpose(0, 2, 4, 1, 3, 5).reshape(6, 12, K * 64)
        jnet = JNet(action_dim=4, torso="patch", prepatched=prepatched, compute_dtype=jdt)
        params = jax.tree.map(np.asarray, jnet.init(jax.random.key(K), jnp.asarray(jin[:1]),
                                                    jnp.asarray(proprio[:1])))
        assert params["params"]["patch_embed"]["kernel"].shape == (K * 64, 128)
        tnet = TNet(action_dim=4, n_patches=12, proprio_dim=11, torso="patch",
                    prepatched=prepatched, compute_dtype=tdt, frame_stack=K, device="cpu")
        tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
        jm, _, jv = jnet.apply(params, jnp.asarray(jin), jnp.asarray(proprio))
        with torch.no_grad():
            tm, _, tv = tnet(torch.from_numpy(np.ascontiguousarray(jin)), torch.from_numpy(proprio))
        tol_m = 1e-3 * np.abs(np.asarray(jm)).max() if bf16 else 1e-6
        tol_v = 1e-3 * np.abs(np.asarray(jv)).max() if bf16 else 1e-6
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=tol_m, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol_v, rtol=0)
        back = interop.policy_params_to_numpy(tnet)
        np.testing.assert_array_equal(back["params"]["patch_embed"]["kernel"],
                                      params["params"]["patch_embed"]["kernel"])


def test_race_state_interop_round_trip():
    jr, _ = _envs(4, 3)
    world, jst = _staged(jr)
    d = interop.to_numpy_tree(jst)
    tst = interop.race_state_from_numpy(d, "cpu")
    back = interop.race_state_to_numpy(tst)
    assert set(back) == set(d)  # the JAX key is left out on both sides
    for k, v in back.items():
        if k != "drones":
            np.testing.assert_array_equal(v, d[k])
    vs = interop.race_state_from_numpy({"race": d, "frames": np.zeros((R, 4, 2, 24, 32),
                                                                      np.uint8)}, "cpu")
    assert isinstance(vs, VisionRaceState) and vs.frames.dtype == torch.uint8


def _train(tmp_path, name, iterations, resume=False, log=False, **kw):
    return train_vision_race(num_envs=16, num_iterations=iterations, num_steps=4, seed=3,
                             rig=TRIG, scan_chunk=1, num_minibatches=2, update_epochs=1,
                             compute_dtype="f32", frame_stack=3, n_obstacles=3,
                             max_episode_steps=6, checkpoint_dir=str(tmp_path / name),
                             checkpoint_every=2, resume=resume,
                             log_dir=str(tmp_path / "log") if log else None, print_every=0,
                             device="cpu", **kw)


def test_train_vision_race_cpu_smoke(tmp_path):
    res = _train(tmp_path, "ck", 3, log=True)
    assert res.iterations == 3
    assert np.isfinite(res.mean_reward_first) and np.isfinite(res.mean_reward_last)
    rows = [json.loads(ln) for ln in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["mean_gates_passed"]) for r in rows)


def test_race_checkpoint_resume_matches_unbroken_run(tmp_path):
    """4 iterations in one run against 2 + a resume for 2 more: the step-4
    checkpoints (params, Adam, the (cols, hist) carry, last obs, generator)
    are equal."""
    _train(tmp_path, "whole", 4)
    _train(tmp_path, "split", 2)
    _train(tmp_path, "split", 2, resume=True)
    a = restore_checkpoint(str(tmp_path / "whole"), 4)
    b = restore_checkpoint(str(tmp_path / "split"), 4)
    assert a["update_count"] == b["update_count"] == 4
    assert isinstance(a["env_state"], tuple) and len(a["env_state"]) == 2
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) > 10
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    c = restore_checkpoint(str(tmp_path / "split"), 2)
    assert not torch.equal(c["env_state"][1], b["env_state"][1])  # premise: the stacks moved


# the scan rollout's options run in tests/test_torch_scan_trainers.py
@pytest.mark.parametrize("kw,match", [
    (dict(distributed=True, rollout="kernel"), "no distributed"),
    (dict(distributed=True, gru=8), "gru \\+ distributed")])
def test_train_vision_race_refuses_what_jax_refuses(kw, match):
    """JAX's own refusals with ``distributed`` (fpyv_tpu/apps/train.py:618-626):
    the kernel rollout (K8), and the GRU."""
    with pytest.raises(ValueError, match=match):
        train_vision_race(num_envs=8, num_iterations=1, device="cpu", **kw)
