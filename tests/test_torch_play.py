"""The port's policy playback against the JAX package: the converted
flagship weights against the repo's orbax checkpoint, the flagship net
against Flax's, one play step of each env teacher-forced against the JAX
env, and ``play_policy``'s output keys against the JAX function's.

Teacher forcing: every step starts both packages from the JAX state (carried
across through ``interop``); the port's ``act`` on the JAX observation is
held against the Flax mean, then both envs step with the Flax mean. The
port's reset draws differ from JAX's (a ``torch.Generator`` against threefry
keys), so a race that resets at a step is compared up to its reset (done
flag, reward, gates); the next step starts from the JAX state again.

Tolerances: the nets as tests/test_torch_policy.py (``ActorCritic`` 1e-5;
the patch net 1e-6 in float32 and 1e-3 in bf16, both of the largest output
where it exceeds 1: the flagship's trained mean reaches ~9); the env
state, frames and rewards as tests/test_torch_race.py and
tests/test_torch_acro.py (one step).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.apps.play import play_policy as jplay
from fpyv_tpu.envs.acro import AcroEnv as JAcro
from fpyv_tpu.envs.multi_race import MultiRaceEnv as JRace
from fpyv_tpu.envs.vision_race import VisionRaceEnv as JVRace
from fpyv_tpu.models.policy import ActorCritic as JAC
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps.play import FLAGSHIP_DIR, load_flagship, make_player, play_policy
from fpyv_tpu_torch.physics.drone import DroneParams as TP

ROOT = Path(__file__).resolve().parents[1]
ORBAX_STEP = ROOT / "runs" / "flagship" / "ck" / "step_0000005600"
RACE_TOL = {"pos": 1e-5, "vel": 1e-5, "att": 1e-6, "rates": 1e-4, "thrust": 1e-4,
            "accel": 1e-4, "prev_gate_dist": 1e-5, "prev_center_dist": 1e-5,
            "episode_return": 1e-5}
ACRO_TOL = {"pos": 1e-5, "vel": 1e-4, "att": 1e-6, "rates": 1e-4, "thrust": 1e-4,
            "accel": 1e-4, "prev_dist": 1e-5, "episode_return": 1e-5, "wind": 0, "t": 0}


def _flagship_tree() -> dict:
    tree = {}
    with np.load(FLAGSHIP_DIR / "policy.npz") as z:
        for key in z.files:
            layer, _, kind = key.partition("/")
            if kind:
                tree.setdefault(layer, {})[kind] = z[key]
            else:
                tree[layer] = z[key]
    return {"params": tree}


def _assert_tree(t: dict, j: dict, live, tol: dict, path=""):
    """Every leaf of the port's state tree against the JAX one, on the
    batch rows in ``live``: within ``tol`` where named, else equal."""
    for k, v in t.items():
        if isinstance(v, dict):
            _assert_tree(v, j[k], live, tol, f"{path}{k}.")
            continue
        a, b = np.asarray(v)[live], np.asarray(j[k])[live]
        if tol.get(k):
            np.testing.assert_allclose(a, b, atol=tol[k], rtol=0, err_msg=path + k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=path + k)


# ---------------------------------------------------------------------------
# The flagship weights
# ---------------------------------------------------------------------------


def test_flagship_npz_equals_orbax_checkpoint():
    """runs/flagship_torch/policy.npz holds the orbax tree's leaves bit for
    bit (restored leaf by leaf from the checkpoint's own metadata)."""
    ocp = pytest.importorskip("orbax.checkpoint")
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(ORBAX_STEP).item_metadata.tree
    args = jax.tree.map(lambda _: ocp.RestoreArgs(restore_type=np.ndarray), meta)
    raw = ckptr.restore(ORBAX_STEP, restore_args=args)
    ref = raw["params"]["params"]
    got = _flagship_tree()["params"]
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, path
        assert a.tobytes() == np.asarray(b).tobytes(), path
    assert got["fc0"]["kernel"].shape == (13835, 256)
    meta_t = json.loads((FLAGSHIP_DIR / "meta.json").read_text())
    meta_j = json.loads((ROOT / "runs" / "flagship" / "meta.json").read_text())
    assert meta_t["play_kwargs"] == meta_j["play_kwargs"] and meta_t["converted_step"] == 5600


@pytest.mark.parametrize("bf16", [False, True])
def test_load_flagship_matches_flax(bf16):
    net, kw = load_flagship("cpu", compute_dtype=torch.bfloat16 if bf16 else None)
    assert kw["frame_stack"] == 4 and net.frame_stack == 4 and net.proprio_dim == 11
    jnet = JNet(action_dim=4, torso="patch", compute_dtype=jnp.bfloat16 if bf16 else None)
    rng = np.random.default_rng(4)
    px = rng.integers(0, 256, size=(6, 4, 72, 96)).astype(np.uint8)
    proprio = rng.normal(size=(6, 11)).astype(np.float32)
    proprio[:, 5:] = 0.0  # the flagship races with the gate one-hot zeroed
    jm, jls, jv = jnet.apply(_flagship_tree(), jnp.asarray(px), jnp.asarray(proprio))
    with torch.no_grad():
        tm, tls, tv = net(torch.from_numpy(px), torch.from_numpy(proprio))
    # test_torch_policy.py's 1e-6 (float32) and 1e-3 (bf16), there on
    # outputs of order 1, here of the largest output: the trained mean
    # reaches ~9, where one float32 ulp is 9.5e-7
    rel = 1e-3 if bf16 else 1e-6
    tol_m = rel * max(1.0, np.abs(np.asarray(jm)).max())
    tol_v = rel * max(1.0, np.abs(np.asarray(jv)).max())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=tol_m, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol_v, rtol=0)
    np.testing.assert_array_equal(tls.detach().numpy(), np.asarray(jls))
    assert np.abs(np.asarray(jm)).max() > 1e-2  # premise: a trained mean, not ~0


# ---------------------------------------------------------------------------
# One play step, teacher-forced
# ---------------------------------------------------------------------------

N_PLAY = 4


def test_vision_race_play_step_teacher_forced():
    """The flagship's eval setup (4 envs, a 4-frame stack, 3 obstacles, the
    one-hot off; race 0 staged just behind gate 1, flying through it): 8
    steps, the port's act and env step against Flax's mean and
    ``step_batched``: frames, gates, crash flags and the state."""
    tree = _flagship_tree()
    jenv = JVRace(race=JRace(n_agents=1, max_episode_steps=2000, gate_size=5.0, n_obstacles=3),
                  gate_onehot=False, frame_stack=4)
    world = jenv.default_world()
    jst, jobs = jenv.reset_batched(jax.random.split(jax.random.key(2), N_PLAY), world)
    gp, gn = np.asarray(world.gate_pos)[1], np.asarray(world.gate_rotmat)[1][:, 0]
    r = jst.race
    pos, vel = np.array(r.drones.pos), np.array(r.drones.vel)
    pgd, ng = np.array(r.prev_gate_dist), np.array(r.next_gate)
    pos[0, 0], vel[0, 0], pgd[0, 0], ng[0, 0] = gp - 0.05 * gn, 12.0 * gn, -0.05, 1
    jst = jst.replace(race=r.replace(drones=r.drones.replace(pos=jnp.asarray(pos),
                                                             vel=jnp.asarray(vel)),
                                     prev_gate_dist=jnp.asarray(pgd), next_gate=jnp.asarray(ng)))
    player = make_player("vision_race", tree, num_envs=N_PLAY, frame_stack=4, n_obstacles=3,
                         gate_onehot=False, device="cpu")
    jnet = JNet(action_dim=4, torso="patch")  # bf16, as the eval
    jstep = jax.jit(lambda s, a: jenv.step_batched(s, a, world))
    g = torch.Generator().manual_seed(0)
    passed = 0
    for _ in range(8):
        proprio = jnp.concatenate([jobs["rates"], jobs["accel_z"], jobs["thrust"],
                                   jobs["gate_onehot"]], axis=-1)
        jmean = np.array(jnet.apply(tree, jobs["pixels"], proprio)[0])
        tobs = {k: torch.from_numpy(np.array(v)) for k, v in jobs.items()}
        tst = interop.race_state_from_numpy(interop.to_numpy_tree(jst), "cpu")
        with torch.no_grad():
            tmean = player.act(tobs)
        np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-3 * np.abs(jmean).max(), rtol=0)
        tst, tobs2, tr, tcrashed, textra = player.env_step(tst, torch.from_numpy(jmean), g)
        jst, jobs, jr, jd, jinfo = jstep(jst, jnp.asarray(jmean))
        done = np.asarray(jd)
        live = ~done
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tcrashed.numpy(), np.asarray(jinfo["crashed"]))
        np.testing.assert_array_equal(textra["gates_passed"].numpy(),
                                      np.asarray(jinfo["gates_passed"]))
        d = np.abs(tobs2["pixels"].numpy()[live].astype(np.float32)
                   - np.asarray(jobs["pixels"])[live].astype(np.float32))
        assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())
        tn, jn = interop.race_state_to_numpy(tst), interop.to_numpy_tree(jst)
        _assert_tree(tn["race"], jn["race"], live, RACE_TOL)
        passed += int(np.asarray(jinfo["gates_passed"]).sum())
        assert set(textra) == {"gates_passed"}
    assert passed >= 1  # premise: race 0 passed gate 1 and the counter moved
    assert (np.asarray(jobs["pixels"]) > 0).mean() > 0.05  # premise: the track is in view


def _state_nets(obs_dim, seed):
    jnet = JAC(action_dim=4, hidden=(32, 32))
    tree = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed),
                                              jnp.zeros((1, obs_dim), jnp.float32)))
    return jnet, tree


def test_acro_play_step_teacher_forced():
    jenv = JAcro(params=JP(att_mode="quat"), dtype=jnp.float32)
    world = jenv.default_world()
    jst, jobs = jax.vmap(lambda k: jenv.reset(k, world))(
        jax.random.split(jax.random.key(3), N_PLAY))
    jnet, tree = _state_nets(jobs.shape[-1], 1)
    player = make_player("acro", tree, num_envs=N_PLAY, hidden=(32, 32), device="cpu")
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, world)))
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        jmean = np.array(jnet.apply(tree, jobs)[0])
        with torch.no_grad():
            tmean = player.act(torch.from_numpy(np.array(jobs)))
        np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-5, rtol=0)
        tst = interop.acro_state_from_numpy(interop.to_numpy_tree(jst), "cpu")
        tst, tobs, tr, tcrashed, textra = player.env_step(tst, torch.from_numpy(jmean), g)
        jst, jobs, jr, jd, jinfo = jstep(jst, jnp.asarray(jmean))
        live = ~np.asarray(jd)
        assert textra == {}
        np.testing.assert_array_equal(tcrashed.numpy(), np.asarray(jinfo["crashed"]))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
        _assert_tree(interop.acro_state_to_numpy(tst), interop.to_numpy_tree(jst), live,
                     dict(ACRO_TOL, dr=0))
        np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live], atol=1e-4, rtol=0)
    assert np.abs(jmean).max() > 1e-3  # premise: the policy acts


def test_race_play_step_teacher_forced():
    """4 races of 4 agents, one shared ActorCritic: the per-race reward,
    crash flags and gate counters and the per-agent table's counters."""
    A = 4
    jenv = JRace(n_agents=A)
    world = jenv.default_world()
    jst, jobs = jax.vmap(lambda k: jenv.reset(k, world))(
        jax.random.split(jax.random.key(4), N_PLAY))
    pos = np.array(jst.drones.pos)
    pos[1, 1] = pos[1, 0] + np.array([0.2, 0.0, 0.0], np.float32)  # race 1: agents 0, 1 touch
    jst = jst.replace(drones=jst.drones.replace(pos=jnp.asarray(pos)))
    jnet, tree = _state_nets(jobs.shape[-1], 2)
    player = make_player("race", tree, num_envs=N_PLAY, hidden=(32, 32), device="cpu")
    jstep = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, world)))
    g = torch.Generator().manual_seed(0)
    contacts = 0
    for _ in range(8):
        jmean = np.array(jnet.apply(tree, jobs.reshape(N_PLAY * A, -1))[0])
        with torch.no_grad():
            tmean = player.act(torch.from_numpy(np.array(jobs)))
        np.testing.assert_allclose(tmean.numpy(), jmean, atol=1e-5, rtol=0)
        tst = interop.race_state_from_numpy(interop.to_numpy_tree(jst), "cpu")
        tst, tobs, tr, tcrashed, textra = player.env_step(tst, torch.from_numpy(jmean), g)
        jst, jobs, jr, jd, jinfo = jstep(jst, jnp.asarray(jmean).reshape(N_PLAY, A, 4))
        live = ~np.asarray(jd)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr).mean(-1), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tcrashed.numpy(), np.asarray(jinfo["crashed"]).any(-1))
        ref = {"gates_passed": np.asarray(jinfo["gates_passed"]).sum(-1),
               "agent_gates": jinfo["gates_passed"], "sum_contact_events": jinfo["contact"],
               "sum_overtakes": jinfo["overtakes"]}
        assert set(textra) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(textra[k].numpy(), np.asarray(v), err_msg=k)
        _assert_tree(interop.race_state_to_numpy(tst), interop.to_numpy_tree(jst), live,
                     RACE_TOL)
        np.testing.assert_allclose(tobs.numpy()[live], np.asarray(jobs)[live], atol=1e-4, rtol=0)
        contacts += int(np.asarray(jinfo["contact"]).sum())
    assert contacts >= 2  # premise: the staged contact counted


# ---------------------------------------------------------------------------
# play_policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env_name", ["acro", "race", "vision_race", "vision"])
def test_play_policy_returns_jax_keys(env_name):
    """steps=8 in chunks of 4 on the CPU: the same keys as the JAX
    function's output, finite values, and the step count."""
    if env_name == "vision_race":
        tree = _flagship_tree()
        kw = dict(frame_stack=4, n_obstacles=3, gate_onehot=False, num_envs=2)
    elif env_name == "vision":  # a fresh patch net on params.yaml's world at 96x72
        tree = jax.tree.map(np.asarray, JNet(action_dim=4, torso="patch").init(
            jax.random.key(0), jnp.zeros((1, 72, 96), jnp.float32), jnp.zeros((1, 5))))
        kw = dict(num_envs=2)
    else:
        obs_dim = 17 if env_name == "acro" else 28
        _, tree = _state_nets(obs_dim, 0)
        kw = dict(hidden=(32, 32), num_envs=3)
    ref = jplay(None, env_name=env_name, steps=8, chunk=4, params=tree, **kw)
    out = play_policy(env_name=env_name, steps=8, chunk=4, params=tree, device="cpu", **kw)
    assert set(out) == set(ref)
    assert out["steps"] == ref["steps"] == 8 and out["env"] == env_name
    assert np.isfinite(out["mean_reward_per_step"])
    for k, v in out.items():
        if isinstance(v, list):
            assert len(v) == len(ref[k]), k
    # a port checkpoint's params (a state_dict) give the same run
    net = make_player(env_name, tree, device="cpu", **{k: v for k, v in kw.items()}).net
    again = play_policy(env_name=env_name, steps=8, chunk=4, params=net.state_dict(),
                        device="cpu", **kw)
    assert again == out


def test_play_policy_reads_a_port_checkpoint(tmp_path):
    from fpyv_tpu_torch.apps.train import train_acro

    train_acro(num_envs=8, num_iterations=1, num_steps=4, scan_chunk=1, hidden=(16, 16),
               checkpoint_dir=str(tmp_path), checkpoint_every=1, print_every=0, device="cpu")
    out = play_policy(str(tmp_path), env_name="acro", steps=4, chunk=4, hidden=(16, 16),
                      device="cpu")
    assert out["steps"] == 4 and np.isfinite(out["mean_reward_per_step"])


# conv and GRU weights play in tests/test_torch_scan_trainers.py


# ---------------------------------------------------------------------------
# play_policy's video: env 0's FPV view through the raycast (K5 on the card)
# ---------------------------------------------------------------------------


def _video_drones(env_name):
    """JAX env-0 drones (several reset and stepped banks) and a JAX world to
    film them in: the acro bank in params.yaml's world (ground, cylinders,
    target), the race bank on its track (gates)."""
    if env_name == "acro":
        from fpyv_tpu.config import SimulatorConfig
        from fpyv_tpu.world.generators import WorldSpec, build_world

        jenv = JAcro(params=JP(att_mode="quat"), dtype=jnp.float32)
        world = jenv.default_world()
        st, _ = jax.jit(jax.vmap(lambda k: jenv.reset(k, world)))(
            jax.random.split(jax.random.key(5), 4))
        step = jax.jit(jax.vmap(lambda s, a: jenv.step(s, a, world)))
        drones = lambda st: st.drone  # noqa: E731
        world = build_world(WorldSpec.from_config(SimulatorConfig(), seed=0), dtype=jnp.float32)
    else:
        jenv = JVRace(race=JRace(n_agents=2, max_episode_steps=2000), frame_stack=1)
        world = jenv.default_world()
        st, _ = jax.jit(lambda k: jenv.reset_batched(k, world))(
            jax.random.split(jax.random.key(6), 4))
        step = jax.jit(lambda s, a: jenv.step_batched(s, a.reshape(8, 4), world))
        drones = lambda st: jax.tree.map(lambda x: x.reshape((8,) + x.shape[2:]),  # noqa: E731
                                         getattr(st, "race", st).drones)
    out = []
    rng = np.random.default_rng(7)
    for _ in range(2):
        d = drones(st)
        out += [jax.tree.map(lambda x, i=i: x[i], d) for i in range(0, 4, 2)]
        st = step(st, jnp.asarray(rng.uniform(-0.5, 0.5, (4 if env_name == "acro" else 8, 4)),
                                  jnp.float32))[0]
    return jenv, world, out


@pytest.mark.parametrize("env_name", ["acro", "vision_race"])
def test_video_frame_teacher_forced(env_name):
    """The port's frame path (``video_frame`` at ``_video_rig((640, 480))``)
    against JAX's ``render_depth_raycast`` on the same env-0 drone. On the
    same camera pose the levels are equal, as tests/test_torch_vision.py
    holds the raycast; each package's own ``camera_pose`` differs by float32
    ulps, which can move an edge by a pixel, so the frames from the drone
    may differ on at most 0.5 % of the pixels (that file's post-step
    tolerance), by one level (measured: 1 pixel of 307 200 in 12 frames)."""
    from fpyv_tpu.apps.play import _video_rig as jrig
    from fpyv_tpu.physics.drone import _att_to_rotmat
    from fpyv_tpu.vision.camera import camera_pose
    from fpyv_tpu.vision.raycast import render_depth_raycast
    from fpyv_tpu_torch.apps.play import _video_rig, video_frame
    from fpyv_tpu_torch.vision.raycast import render_depth_raycast as trender

    jenv, jworld, jdrones = _video_drones(env_name)
    tworld = interop.world_from_numpy(interop.to_numpy_tree(jworld), "cpu")
    rig, params = _video_rig((640, 480)), TP(att_mode="quat")  # both envs' drone
    assert jenv.params.att_mode == params.att_mode
    assert rig.resolution == (640, 480) and rig.fov_deg == 120.0 and rig.pitch_deg == 35.0
    lit = 0.0
    for jd in jdrones:
        R = _att_to_rotmat(jenv.params, jd.att)
        cam_pos, cam_R = camera_pose(jrig((640, 480)), jd.pos, R)
        ref = np.asarray(render_depth_raycast(jrig((640, 480)), cam_pos, cam_R, jworld,
                                              max_depth=25.0))
        same_pose = trender(rig, torch.from_numpy(np.array(cam_pos)),
                            torch.from_numpy(np.array(cam_R)), tworld, max_depth=25.0).numpy()
        np.testing.assert_array_equal(same_pose, ref)
        td = interop.drone_state_from_numpy(interop.to_numpy_tree(jd), "cpu")
        out = video_frame(rig, params, td, tworld).numpy()
        assert out.shape == (480, 640) and out.dtype == np.uint8
        diff = np.abs(out.astype(np.int16) - ref)
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
        lit = max(lit, (ref > 0).mean())
    assert lit > 0.01  # the world is in view


def test_play_policy_saves_video(tmp_path):
    """play_policy(save_video=...) end to end on the CPU: acro, 16 envs, one
    chunk of 8; a frame a step in the file, the keys JAX's function adds."""
    import cv2

    _, tree = _state_nets(17, 0)
    path = tmp_path / "flight.mp4"
    out = play_policy(env_name="acro", steps=8, chunk=8, num_envs=16, params=tree,
                      hidden=(32, 32), save_video=str(path), device="cpu")
    assert out["video"] == str(path) and out["video_frames"] == out["steps"] == 8
    cap = cv2.VideoCapture(str(path))
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (640, 480)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 8
    # the same run without the video, and its frames through a sink instead
    frames = []
    plain = play_policy(env_name="acro", steps=8, chunk=8, num_envs=16, params=tree,
                        hidden=(32, 32), device="cpu", frame_sink=frames.append)
    assert {k: v for k, v in out.items() if not k.startswith("video")} == plain
    assert len(frames) == 8 and frames[0].shape == (480, 640) and frames[0].dtype == np.uint8