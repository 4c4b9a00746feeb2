"""Vision gate racing: the race of :mod:`fpyv_tpu_torch.envs.multi_race` on
PIXELS (mirrors ``fpyv_tpu.envs.vision_race``).

The observation is the FPV depth view of the gate track (gate frames and
ground through the analytic raycast, K5 on a CUDA state) with the other
agents as spheres of ``opponent_radius`` and the orbiting obstacles at
episode time t, plus the IMU rows and a one-hot of the next gate (zeroed
with ``gate_onehot=False``). ``frame_width`` defaults to a 0.35 m band so the
gate frames land on the 96x72 sensor from across the 12 m track.

``frame_stack=K > 1`` stacks the last K frames as the pixel observation
(newest last); a race's reset flushes its history to the respawn frame.
Where the JAX env vmaps over PRNG keys, the batched entry points here take
one ``torch.Generator`` and the number of races.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Union

import torch

from fpyv_tpu_torch.envs.base import Part
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv, MultiRaceState
from fpyv_tpu_torch.physics.drone import DroneParams, _att_to_rotmat
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose
from fpyv_tpu_torch.vision.raycast import render_depth_raycast


def default_race_rig() -> CameraRig:
    return CameraRig(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                     resolution=(96, 72))


def per_camera_world(world: World, centers: torch.Tensor, radius: torch.Tensor) -> World:
    """A shared ``world`` as a per-camera batched world (n leading) whose
    sphere bank is ``centers`` (n, S, 3) with ``radius`` (n, S), all active:
    what the raycast renders for a view with its own spheres."""
    n = centers.shape[0]
    w = World(**{f.name: getattr(world, f.name).expand((n,) + tuple(getattr(world, f.name).shape))
                 for f in dataclasses.fields(World)})
    return w.replace(sphere_center=centers, sphere_radius=radius,
                     sphere_active=torch.ones(radius.shape, dtype=torch.bool,
                                              device=radius.device))


@dataclass
class VisionRaceState:
    """Race state and the frame-stack history (``frame_stack > 1`` only):
    the K-1 previous depth frames per agent, newest last."""

    race: MultiRaceState
    frames: torch.Tensor  # (n_races, A, K-1, H, W)


@dataclass(frozen=True)
class VisionRaceEnv:
    """MultiRaceEnv whose observation is the rendered track."""

    race: MultiRaceEnv = field(default_factory=lambda: MultiRaceEnv(n_agents=1,
                                                                    max_episode_steps=2000))
    rig: CameraRig = field(default_factory=default_race_rig)
    max_depth: float = 40.0  # the far gates stay above level 0
    frame_width: float = 0.35
    pixel_dtype: str = "u8"
    gate_onehot: bool = True  # False zeroes the next-gate block (pixels + IMU only)
    opponent_radius: float = 0.3  # the other agents, drawn as spheres
    show_opponents: bool = True  # False leaves them out of the frame
    frame_stack: int = 1  # the last K frames as the pixel obs, newest last

    @property
    def params(self) -> DroneParams:
        return self.race.params

    @property
    def n_gates(self) -> int:
        return self.race.n_gates

    def default_world(self, device=None) -> World:
        return self.race.default_world(device)

    # -- observation ---------------------------------------------------------

    def render_scene(self, state: MultiRaceState, world: World):
        """What the raycast renders for every agent's camera: (cam_pos (n, 3),
        cam_R (n, 3, 3), the world, include), n = every leading index times
        A; with opponents in view or obstacles, a per-camera world whose
        spheres are the other agents and the obstacles at episode time t."""
        A = self.race.n_agents
        pos = state.drones.pos  # (..., A, 3)
        cam_pos, cam_R = camera_pose(self.rig, pos, _att_to_rotmat(self.params, state.drones.att))
        lead = tuple(pos.shape[:-1])
        sph_c, sph_r = [], []
        if A > 1 and self.show_opponents:
            idx = torch.tensor([[j for j in range(A) if j != i] for i in range(A)],
                               dtype=torch.long, device=pos.device)
            others = pos[..., idx, :]  # (..., A, A-1, 3)
            sph_c.append(others)
            sph_r.append(torch.full(others.shape[:-1], self.opponent_radius,
                                    dtype=torch.float32, device=pos.device))
        if self.race.n_obstacles:
            obs_c = self.race._obstacles_at(world, state.t)  # (..., S, 3)
            obs_c = obs_c[..., None, :, :].expand(lead + obs_c.shape[-2:])
            sph_c.append(obs_c)
            sph_r.append(world.sphere_radius.to(torch.float32).expand(obs_c.shape[:-1]))
        cams = (cam_pos.reshape(-1, 3), cam_R.reshape(-1, 3, 3))
        if sph_c:
            centers = torch.cat(sph_c, dim=-2)
            rworld = per_camera_world(world, centers.reshape((-1,) + centers.shape[-2:]),
                                      torch.cat(sph_r, dim=-1).reshape(-1, centers.shape[-2]))
            return (*cams, rworld, ("spheres", "gates", "ground"))
        return (*cams, world, ("gates", "ground"))

    def _render(self, state: MultiRaceState, world: World) -> torch.Tensor:
        """uint8 depth frames (..., A, H, W) of every agent's camera."""
        W, H = self.rig.resolution
        cam_pos, cam_R, rworld, include = self.render_scene(state, world)
        img = render_depth_raycast(self.rig, cam_pos, cam_R, rworld, max_depth=self.max_depth,
                                   include=include, frame_width=self.frame_width)
        return img.reshape(tuple(state.drones.pos.shape[:-1]) + (H, W))

    def _obs(self, state: MultiRaceState, world: World):
        """Per-agent obs dict; every leaf keeps the (..., A, ...) axes."""
        img = self._render(state, world)
        pixels = img if self.pixel_dtype == "u8" else img.to(torch.float32) / 255.0
        d = state.drones
        onehot = torch.nn.functional.one_hot(state.next_gate.long(), self.n_gates).to(
            torch.float32)
        if not self.gate_onehot:
            onehot = torch.zeros_like(onehot)
        return {"pixels": pixels, "rates": d.rates / self.params.max_rates,
                "accel_z": d.accel[..., 2:3] / 30.0,
                "thrust": d.thrust[..., None] / self.params.thrust_curve.max_force,
                "gate_onehot": onehot}

    # -- batched API: the learner sees a flat (n_races * A) agent batch

    @staticmethod
    def _flat(obs):
        return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in obs.items()}

    @staticmethod
    def _stack(obs, frames):
        """pixels (R, A, H, W) under the history (R, A, K-1, H, W) -> the
        stacked pixels (R, A, K, H, W) and the shifted history."""
        stacked = torch.cat([frames, obs["pixels"][..., None, :, :]], dim=-3)
        return dict(obs, pixels=stacked), stacked[..., 1:, :, :]

    def reset_batched(self, generator: torch.Generator, world: World, n_races: int):
        state, _ = self.race.reset(generator, world, (n_races,))
        obs = self._obs(state, world)
        if self.frame_stack > 1:
            # the history: K-1 copies of the first frame
            cur = obs["pixels"][..., None, :, :]
            frames = cur.expand(cur.shape[:-3] + (self.frame_stack - 1,) + cur.shape[-2:])
            obs, frames = self._stack(obs, frames)
            return VisionRaceState(race=state, frames=frames), self._flat(obs)
        return state, self._flat(obs)

    def step_batched(self, state: Union[MultiRaceState, VisionRaceState], action,
                     world: World, generator: Optional[torch.Generator] = None,
                     part: Optional[Part] = None):
        """action (n_races * A, 4), flat over agents; ``part`` as in
        ``MultiRaceEnv.step``."""
        A = self.race.n_agents
        stacked = isinstance(state, VisionRaceState)
        race_state = state.race if stacked else state
        st, _, reward, done, info = self.race.step(
            race_state, action.reshape(-1, A, action.shape[-1]), world, generator=generator,
            part=part)
        obs = self._obs(st, world)
        if stacked:
            # a race's reset flushes its history to the respawn frame
            cur = obs["pixels"][..., None, :, :]
            fresh = cur.expand(cur.shape[:-3] + (self.frame_stack - 1,) + cur.shape[-2:])
            frames = torch.where(done[:, None, None, None, None], fresh, state.frames)
            obs, frames = self._stack(obs, frames)
            st = VisionRaceState(race=st, frames=frames)
        obs = self._flat(obs)
        # an agent's episode ends at its own crash or at the race's reset
        info = dict(info, gates_passed=info["gates_passed"].reshape(-1),
                    crashed=(info["crashed"] | done[:, None]).reshape(-1))
        return st, obs, reward.reshape(-1), done, info
