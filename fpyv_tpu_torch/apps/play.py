"""Policy playback: fly a trained policy deterministically and report its
episode statistics (mirrors ``fpyv_tpu.apps.play``).

``play_policy`` rolls the actor's mean action over a bank of envs, ``chunk``
steps between host reads, and returns the JAX function's dict: reward per
step, crash events, the last step's gate counters (``final_gates_passed_mean``,
``agent_gates_mean``) and the summed per-agent event counters. Four envs:

- ``"acro"``: ``AcroEnv`` (quaternion attitude) and ``ActorCritic``;
- ``"vision"``: ``VisionAcroEnv(renderer="raycast", target_only=False)`` on
  params.yaml's world or per-env randomized worlds, ``PixelActorCritic``;
- ``"vision_race"``: ``VisionRaceEnv`` (the FPV gate race, frame stacks,
  obstacles, several agents) and ``PixelActorCritic``;
- ``"race"``: ``MultiRaceEnv`` with one ``ActorCritic`` for every agent.

The pixel nets run in bf16, as the JAX package's default ``compute_dtype``,
with the patch or the conv torso as the weights hold. A GRU checkpoint
(``gru`` in the weights) plays with its hidden state in the carry, zeroed
where an episode ends, as in training.
Each step runs the net and the eager env step (whose render is K5 on a CUDA
state), as the JAX function steps its envs' ``step`` under ``jax.vmap``.
Resets draw from a ``torch.Generator`` seeded with ``seed``.

``save_video`` records env 0's FPV view (agent 0 of race 0 for the races):
each step renders it at ``video_resolution`` through the analytic raycast
(:func:`video_frame`: ``render_depth_raycast``, K5 on the card, one camera)
from ``_video_rig`` (pitch 35°, offset (0.1, 0, 0), fov 120°, built once a
call, so K5's ray grid is made once); a chunk's frames, positions and
velocities stack on the device and reach the host in one copy, then each
frame gets the HUD (speed, height) and goes to
:class:`~fpyv_tpu_torch.viz.video.VideoWriterSink` (cv2), or to
``frame_sink`` when one is given instead.

Weights come from the port's own checkpoints (``checkpoint_dir``,
:mod:`fpyv_tpu_torch.utils.checkpoint`), or ``params``: a port
``state_dict`` or a Flax tree of numpy arrays. :func:`load_flagship` reads
the shipped flagship racer, converted once from its orbax checkpoint into
``runs/flagship_torch/policy.npz`` (``tools/convert_flagship.py``), with
numpy alone.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch import interop
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.base import tree_map_tensors
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv, default_race_rig
from fpyv_tpu_torch.models.policy import ActorCritic, PixelActorCritic
from fpyv_tpu_torch.ops.vision_kernel import world_batched
from fpyv_tpu_torch.physics.drone import DroneParams, DroneState, _att_to_rotmat
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose
from fpyv_tpu_torch.vision.raycast import render_depth_raycast
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint

FLAGSHIP_DIR = Path(__file__).resolve().parents[2] / "runs" / "flagship_torch"
PATCH_PIXELS = 64  # 8x8 patches


def _inner(params):
    inner = params
    while hasattr(inner, "get") and "params" in inner:
        inner = inner["params"]
    return inner


def _detect_torso(params, fallback: str = "patch") -> str:
    """The trained image torso from a Flax parameter tree ('patch_embed'
    for patch, 'conv0' for conv); other trees give the fallback."""
    try:
        keys = set(_inner(params).keys())
    except AttributeError:
        return fallback
    if "patch_embed" in keys:
        return "patch"
    if "conv0" in keys:
        return "conv"
    return fallback


def _detect_patch_pool(params) -> int:
    """patch_pool from a Flax parameter tree: the 'patch_pool' layer's
    kernel is (pool*embed, embed); 1 without one."""
    try:
        wp = _inner(params)["patch_pool"]["kernel"]
    except (KeyError, TypeError):
        return 1
    return int(wp.shape[0]) // int(wp.shape[1])


def _detect_gru(params) -> int:
    """The GRU width from a Flax parameter tree (the hidden-to-z kernel is
    (H, H)); 0 for a feedforward net."""
    try:
        return int(_inner(params)["gru"]["hz"]["kernel"].shape[-1])
    except (KeyError, TypeError):
        return 0


def _flax_tree(params) -> dict:
    """A port ``state_dict`` or a Flax tree -> the Flax tree of numpy
    arrays that the detectors read."""
    inner = _inner(params)
    if any("." in k for k in inner):  # "layer.weight": a state_dict
        return interop.policy_params_to_numpy(inner)
    return {"params": inner}


def _video_rig(resolution: Tuple[int, int]) -> CameraRig:
    return CameraRig(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                     resolution=tuple(resolution))


def video_frame(rig: CameraRig, params: DroneParams, drone: DroneState,
                world: World) -> torch.Tensor:
    """One drone's FPV view: (H, W) uint8 levels from the analytic raycast
    at max_depth 25 (K5, one camera, on a CUDA drone)."""
    R = _att_to_rotmat(params, drone.att)
    cam_pos, cam_R = camera_pose(rig, drone.pos, R)
    return render_depth_raycast(rig, cam_pos, cam_R, world, max_depth=25.0)


def _first(tree, n: int = 1):
    """Row 0 of the ``n`` leading axes of every tensor of ``tree``."""
    return tree_map_tensors(lambda x: x[(0,) * n], tree)


def load_flagship(device=None, compute_dtype=torch.bfloat16):
    """The shipped flagship racer: (``PixelActorCritic`` on ``device``, CUDA
    unless told, and the play kwargs of its meta.json). The net is the
    patch torso over 96x72 frames (108 patches), a 4-frame stack and 11
    proprio inputs, in ``compute_dtype`` (bf16 as trained; None = float32)."""
    device = resolve_device(device)
    meta = json.loads((FLAGSHIP_DIR / "meta.json").read_text())
    with np.load(FLAGSHIP_DIR / "policy.npz") as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for key, arr in flat.items():
        layer, _, kind = key.partition("/")
        if kind:
            tree.setdefault(layer, {})[kind] = arr
        else:
            tree[layer] = arr
    frame_stack = meta["play_kwargs"].get("frame_stack", 1)
    embed_in, embed = tree["patch_embed"]["kernel"].shape
    W, H = default_race_rig().resolution
    n_patches = (W * H) // PATCH_PIXELS
    net = PixelActorCritic(action_dim=tree["pi_mean"]["kernel"].shape[1], n_patches=n_patches,
                           proprio_dim=tree["fc0"]["kernel"].shape[0] - n_patches * embed,
                           torso="patch", compute_dtype=compute_dtype,
                           frame_stack=embed_in // PATCH_PIXELS, device=device)
    if net.frame_stack != frame_stack:
        raise ValueError(f"meta.json asks for frame_stack={frame_stack}, the weights hold "
                         f"{net.frame_stack}")
    net.load_state_dict(interop.policy_params_from_numpy({"params": tree}, device))
    return net, dict(meta["play_kwargs"])


@dataclass
class Player:
    """One env bank and its policy: ``reset(generator) -> (state, obs)``,
    ``act(obs) -> mean action``, ``env_step(state, action, generator) ->
    (state, obs, reward, crashed, extra)``; a play step is
    ``env_step(state, act(obs), generator)``. A GRU net (``gru > 0``)
    carries ``(env state, hidden)`` as its state, and ``act(obs, hidden) ->
    (mean action, hidden')``; the step zeroes the hidden where ``crashed``.
    ``view(env state) -> (drone, world)`` is what the video films: env 0's
    drone (agent 0 of race 0) and its world; ``params`` the env's drone."""

    net: torch.nn.Module
    reset: Callable
    act: Callable
    env_step: Callable
    view: Callable
    params: DroneParams
    gru: int = 0

    def frame_state(self, state):
        """(drone, world) of the video's env from a play state."""
        return self.view(state[0] if self.gru else state)

    def step(self, state, obs, generator):
        if not self.gru:
            return self.env_step(state, self.act(obs), generator)
        st, hidden = state
        mean, hidden = self.act(obs, hidden)
        st, obs, r, crashed, extra = self.env_step(st, mean, generator)
        hidden = torch.where(crashed[..., None], torch.zeros_like(hidden), hidden)
        return (st, hidden), obs, r, crashed, extra


def _pixel_act(net: PixelActorCritic, proprio: Callable) -> Callable:
    """``act`` of a pixel net: the mean action, and the new hidden with a GRU."""
    if net.gru:
        def act(obs, hidden):
            mean, _, _, hidden = net(obs["pixels"], proprio(obs), hidden)
            return mean, hidden
    else:
        def act(obs):
            return net(obs["pixels"], proprio(obs))[0]
    return act


def _with_hidden(reset: Callable, rows: int, gru: int, device) -> Callable:
    """A reset whose state carries a zero GRU hidden of ``rows`` rows."""
    if not gru:
        return reset

    def reset_h(generator):
        st, obs = reset(generator)
        return (st, torch.zeros((rows, gru), dtype=torch.float32, device=device)), obs
    return reset_h


def make_player(env_name: str, tree: dict, num_envs: int = 16, hidden=(128, 128),
                n_agents: Optional[int] = None, randomize_worlds: bool = False,
                torso: Optional[str] = None, gate_onehot: bool = True, frame_stack: int = 1,
                show_opponents: bool = True, gate_size: float = 5.0, n_obstacles: int = 0,
                permute_spawns: bool = False, world_generator: Optional[torch.Generator] = None,
                device=None) -> Player:
    """The env bank, the net with the weights of the Flax tree ``tree``,
    and the reset and step of ``play_policy`` (arguments as its)."""
    device = resolve_device(device)
    torso = _detect_torso(tree) if torso is None else torso
    gru = _detect_gru(tree)
    weights = interop.policy_params_from_numpy(tree, device)
    rows = num_envs  # the rows a GRU's hidden holds: one an env, one an agent in a race

    if env_name == "acro":
        env = AcroEnv(params=DroneParams(att_mode="quat"))
        world = env.default_world(device)
        net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=hidden, device=device)

        def reset(generator):
            return env.reset(generator, world, (num_envs,))

        def act(obs):
            return net(obs)[0]

        def env_step(st, action, generator):
            st, obs, r, _, info = env.step(st, action, world, generator=generator)
            return st, obs, r, info["crashed"], {}

        def view(st):
            return _first(st.drone), world

    elif env_name == "vision":
        env = VisionAcroEnv(renderer="raycast", target_only=False)
        if randomize_worlds:
            world, bank = env.make_randomized_worlds(world_generator, num_envs, device=device)
        else:
            world, bank = env.make_world(device=device)  # one world for every env
        W, H = env.rig.resolution
        net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PATCH_PIXELS, torso=torso,
                               patch_pool=_detect_patch_pool(tree), gru=gru, image_hw=(H, W),
                               device=device)

        def reset(generator):
            return env.reset_batched(generator, world, bank, num_envs)

        act = _pixel_act(net, lambda obs: torch.cat([obs["rates"], obs["accel_z"],
                                                     obs["thrust"]], dim=-1))

        def env_step(st, action, generator):
            st, obs, r, _, info = env.step_batched(st, action, world, bank, generator=generator)
            return st, obs, r, info["crashed"], {}

        world0 = _first(world) if world_batched(world) else world

        def view(st):
            return _first(st.drone), world0

    elif env_name == "vision_race":
        A = n_agents or 1
        env = VisionRaceEnv(
            race=MultiRaceEnv(n_agents=A, max_episode_steps=2000, gate_size=gate_size,
                              n_obstacles=n_obstacles, permute_spawns=permute_spawns),
            gate_onehot=gate_onehot, frame_stack=frame_stack, show_opponents=show_opponents)
        world = env.default_world(device)
        W, H = env.rig.resolution
        net = PixelActorCritic(action_dim=4, n_patches=(W * H) // PATCH_PIXELS,
                               proprio_dim=5 + env.n_gates, torso=torso,
                               patch_pool=_detect_patch_pool(tree), frame_stack=frame_stack,
                               gru=gru, image_hw=(H, W), device=device)
        rows = num_envs * A

        def reset(generator):
            return env.reset_batched(generator, world, num_envs)

        act = _pixel_act(net, lambda obs: torch.cat([obs["rates"], obs["accel_z"], obs["thrust"],
                                                     obs["gate_onehot"]], dim=-1))

        def env_step(st, action, generator):
            st, obs, r, _, info = env.step_batched(st, action, world, generator=generator)
            extra = {"gates_passed": info["gates_passed"]}
            if A > 1:  # the per-agent eval table's counters
                extra["agent_gates"] = info["gates_passed"].reshape(-1, A)
                extra["sum_contact_events"] = info["contact"]
                extra["sum_overtakes"] = info["overtakes"]
            return st, obs, r, info["crashed"], extra

        def view(st):
            return _first(st.race.drones, 2), world

    elif env_name == "race":
        A = n_agents or 4
        env = MultiRaceEnv(n_agents=A, gate_size=gate_size, permute_spawns=permute_spawns)
        world = env.default_world(device)
        net = ActorCritic(action_dim=4, obs_dim=env.obs_dim, hidden=hidden, device=device)

        def reset(generator):
            return env.reset(generator, world, (num_envs,))

        def act(obs):
            return net(obs.reshape(num_envs * A, -1))[0]

        def env_step(st, action, generator):
            st, obs, r, _, info = env.step(st, action.reshape(num_envs, A, -1), world,
                                           generator=generator)
            return (st, obs, r.mean(dim=-1), info["crashed"].any(dim=-1),
                    {"gates_passed": info["gates_passed"].sum(dim=-1),
                     "agent_gates": info["gates_passed"],
                     "sum_contact_events": info["contact"],
                     "sum_overtakes": info["overtakes"]})

        def view(st):  # agent 0 of race 0
            return _first(st.drones, 2), world

    else:
        raise ValueError(f"unknown env {env_name!r}")

    net.load_state_dict(weights)
    return Player(net=net, reset=_with_hidden(reset, rows, gru, device), act=act,
                  env_step=env_step, view=view, params=env.params, gru=gru)


def play_policy(
    checkpoint_dir: Optional[str] = None,
    env_name: str = "acro",  # 'acro' | 'vision' | 'race' | 'vision_race'
    steps: int = 600,
    num_envs: int = 16,
    seed: int = 0,
    hidden=(128, 128),  # the trained net's (acro/race)
    n_agents: Optional[int] = None,  # drones a race: 4 for 'race', 1 for 'vision_race'
    randomize_worlds: bool = False,  # vision
    torso: Optional[str] = None,  # vision nets: None = read from the weights
    gate_onehot: bool = True,  # (vision_race) as trained
    frame_stack: int = 1,  # (vision_race) as trained
    show_opponents: bool = True,  # (vision_race)
    gate_size: float = 5.0,  # (race/vision_race) the trained track's
    n_obstacles: int = 0,  # (vision_race) moving track obstacles
    permute_spawns: bool = False,  # (race/vision_race) random spawn slots
    save_video: Optional[str] = None,  # video file of env 0's FPV view (cv2)
    video_resolution: Tuple[int, int] = (640, 480),
    chunk: int = 120,  # steps between host reads
    step_checkpoint: Optional[int] = None,  # None = latest
    params=None,  # bypass the checkpoint: a port state_dict or a Flax tree
    device=None,  # CUDA unless "cpu"
    frame_sink: Optional[Callable] = None,  # callable(uint8 frame): the HUD'd
    #   video frames go here instead of a file (save_video takes precedence)
) -> dict:
    """Fly the deterministic policy (the actor's mean) for ``steps``,
    rounded up to a multiple of ``chunk``, over ``num_envs`` envs; returns
    the episode statistics (keys as the JAX function's, with ``video`` and
    ``video_frames`` when ``save_video`` is given)."""
    if params is None:
        if checkpoint_dir is None:
            raise ValueError("pass checkpoint_dir or params")
        params = restore_checkpoint(checkpoint_dir, step_checkpoint)["params"]
    seeds = np.random.SeedSequence(seed).generate_state(2)
    g_env = torch.Generator().manual_seed(int(seeds[0]))
    g_world = torch.Generator().manual_seed(int(seeds[1]))
    player = make_player(env_name, _flax_tree(params), num_envs=num_envs, hidden=hidden,
                         n_agents=n_agents, randomize_worlds=randomize_worlds, torso=torso,
                         gate_onehot=gate_onehot, frame_stack=frame_stack,
                         show_opponents=show_opponents, gate_size=gate_size,
                         n_obstacles=n_obstacles, permute_spawns=permute_spawns,
                         world_generator=g_world, device=device)

    sink = frame_sink
    if save_video:
        from fpyv_tpu_torch.viz.video import VideoWriterSink

        sink = VideoWriterSink(save_video, fps=60.0)
    rig = _video_rig(video_resolution) if sink is not None else None

    total_r, crash_events, extra_sums, done_steps = 0.0, 0, {}, 0
    try:
        with torch.no_grad():
            st, obs = player.reset(g_env)
            while done_steps < steps:
                outs, frames, motion = [], [], []
                for _ in range(chunk):
                    st, obs, r, crashed, extra = player.step(st, obs, g_env)
                    outs.append((r, crashed, extra))
                    if rig is not None:
                        drone0, world0 = player.frame_state(st)
                        frames.append(video_frame(rig, player.params, drone0, world0))
                        motion.append(torch.cat([drone0.pos, drone0.vel]))
                host = _to_host(outs)
                total_r += float(np.sum(host["r"])) / num_envs
                crash_events += int(np.sum(host["crashed"]))
                for k in outs[0][2]:
                    v = host[k]
                    if k.startswith("sum_"):  # per-step event counters
                        extra_sums[k] = extra_sums.get(k, 0) + np.sum(
                            v.astype(np.int64), axis=tuple(range(v.ndim - 1)))
                    else:
                        extra_sums[k] = v[-1]  # running counters: the last step's
                if rig is not None:
                    _sink_frames(sink, torch.stack(frames), torch.stack(motion))
                done_steps += chunk
    finally:
        if save_video:
            sink.close()

    out = {
        "env": env_name,
        "steps": int(done_steps),
        "num_envs": int(num_envs),
        "mean_reward_per_step": total_r / done_steps,
        "crash_events": crash_events,
    }
    for k, v in extra_sums.items():
        if k == "agent_gates":
            # mean gates per agent slot across races at the last step
            out["agent_gates_mean"] = np.mean(np.asarray(v, np.float64), axis=0).tolist()
        elif k.startswith("sum_"):
            out[k[4:]] = np.asarray(v, np.int64).tolist()
        else:
            out[f"final_{k}_mean"] = float(np.mean(v))
    if save_video:
        out["video"] = sink.path
        out["video_frames"] = sink.frames_written
    return out


def _sink_frames(sink: Callable, frames: torch.Tensor, motion: torch.Tensor) -> None:
    """A chunk's (T, H, W) uint8 frames and (T, 6) positions and
    velocities to the host in one copy each, the HUD on every frame (speed,
    height), each to ``sink``."""
    from fpyv_tpu_torch.viz.hud import hud_overlay

    frames, motion = frames.cpu().numpy(), motion.cpu().numpy()
    for frame, pv in zip(frames, motion):
        sink(hud_overlay(frame, speed_ms=float(np.linalg.norm(pv[3:])), height_m=float(pv[2])))


def _to_host(outs) -> dict:
    """A chunk's per-step (reward, crashed, extra) -> numpy arrays with a
    leading (chunk,) axis, through ONE device-to-host copy (float64 holds
    the rewards and the integer counters exactly)."""
    named = {"r": [o[0] for o in outs], "crashed": [o[1] for o in outs]}
    for k in outs[0][2]:
        named[k] = [o[2][k] for o in outs]
    stacked = {k: torch.stack(v) for k, v in named.items()}
    flat = torch.cat([v.reshape(len(outs), -1).to(torch.float64) for v in stacked.values()],
                     dim=1).cpu().numpy()
    host, col = {}, 0
    for k, v in stacked.items():
        width = v[0].numel()
        arr = flat[:, col:col + width].reshape(tuple(v.shape))
        host[k] = (arr.astype(np.float32) if v.is_floating_point()
                   else arr.astype(np.bool_) if v.dtype == torch.bool else arr.astype(np.int64))
        col += width
    return host
