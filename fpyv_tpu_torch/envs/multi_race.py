"""Multi-agent drone race env: A drones per world racing a gate track
(mirrors ``fpyv_tpu.envs.multi_race``).

A agents share one gate track (gates on a circle), race through the gates in
order and see each other. An agent passes its next gate when the signed
distance to the gate plane (normal = R[:, 0], components.py:811-822) crosses
from negative to positive between consecutive steps while the crossing point
lies within the gate's half-size laterally. Reward: gate bonus + progress
toward the next gate's centre + alive bonus - crash penalty (on the crash
transition) + ``w_overtake`` times the race positions gained. Contact between
two agents crashes both. Moving obstacles orbit the track on CircularPaths as
a pure function of episode time, so resets rewind them.

Where the JAX env vmaps one race over a batch of PRNG keys, this one writes
the batch dimensions out (every state field is (..., A, ...), ``t`` is
(...,)) and draws from an explicit ``torch.Generator``; the state has no
``key``. The random streams differ from the JAX env's, so trajectories agree
from the same state until the first reset.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where
from fpyv_tpu_torch.physics.drone import DroneParams, DroneState, drone_reset, drone_step
from fpyv_tpu_torch.physics.world import World, empty_world


@dataclass
class MultiRaceState:
    drones: DroneState  # fields have leading dims (..., A)
    next_gate: torch.Tensor  # (..., A) int32
    prev_gate_dist: torch.Tensor  # (..., A) signed plane distance to the next gate
    prev_center_dist: torch.Tensor  # (..., A) distance to the next gate's centre
    gates_passed: torch.Tensor  # (..., A) int32 total
    prev_rank: torch.Tensor  # (..., A) int32 race position (0 = leader)
    t: torch.Tensor  # (...,) int32
    episode_return: torch.Tensor  # (..., A)

    def replace(self, **changes) -> "MultiRaceState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class MultiRaceEnv:
    params: DroneParams = field(default_factory=lambda: DroneParams(att_mode="quat"))
    n_agents: int = 4
    n_gates: int = 6
    track_radius: float = 12.0
    gate_size: float = 5.0
    gate_height: float = 3.0
    spawn_radius: float = 2.0
    spawn_height: float = 3.0
    agent_collision_radius: float = 0.35  # ~2 arm radii
    max_episode_steps: int = 2000
    # obstacle spheres orbiting the gate circle (CircularPath), phases
    # spread evenly over one revolution
    n_obstacles: int = 0
    obstacle_radius: float = 0.8
    obstacle_period: int = 600  # steps per revolution
    w_gate: float = 10.0
    w_progress: float = 1.0
    w_alive: float = 0.005
    w_crash: float = 10.0
    w_overtake: float = 0.0  # per race position gained (zero-sum); 0 disables
    others_in_obs: bool = True  # False zeroes the others block of the obs
    permute_spawns: bool = False  # random agent-to-spawn-slot assignment per episode
    dtype: torch.dtype = torch.float32

    # ---- track ------------------------------------------------------------

    def default_world(self, device=None) -> World:
        """The circular track on ``device`` (CUDA unless told): n_gates gates
        of gate_size on the circle, normals along the racing direction."""
        import numpy as np

        device = resolve_device(device)
        kw = dict(dtype=self.dtype, device=device)
        theta = np.linspace(0, 2 * np.pi, self.n_gates + 1)[:-1]
        pos = np.stack([np.cos(theta) * self.track_radius, np.sin(theta) * self.track_radius,
                        np.full_like(theta, self.gate_height)], axis=-1)
        rots = np.stack([np.array([[np.cos(t + np.pi / 2), -np.sin(t + np.pi / 2), 0],
                                   [np.sin(t + np.pi / 2), np.cos(t + np.pi / 2), 0],
                                   [0, 0, 1.0]]) for t in theta], axis=0)
        w = empty_world(n_spheres=self.n_obstacles, n_cylinders=0, n_gates=self.n_gates,
                        ground=True, dtype=self.dtype, device=device)
        w = w.replace(gate_pos=torch.as_tensor(pos, **kw), gate_rotmat=torch.as_tensor(rots, **kw),
                      gate_size=torch.full((self.n_gates,), self.gate_size, **kw))
        if self.n_obstacles:
            S = self.n_obstacles
            center = torch.tensor([0.0, 0.0, self.gate_height], **kw)
            phases = (np.arange(S) * self.obstacle_period) // max(S, 1)
            w = w.replace(
                sphere_radius=torch.full((S,), self.obstacle_radius, **kw),
                sphere_active=torch.ones((S,), dtype=torch.bool, device=device),
                sphere_path_center=center.expand(S, 3).clone(),
                sphere_path_radius=torch.full((S,), self.track_radius, **kw),
                sphere_path_res=torch.full((S,), self.obstacle_period, dtype=torch.int32,
                                           device=device),
                sphere_path_count=torch.as_tensor(phases, dtype=torch.int32, device=device),
                sphere_has_path=torch.ones((S,), dtype=torch.bool, device=device),
            )
            w = w.replace(sphere_center=self._obstacles_at(
                w, torch.zeros((), dtype=torch.int32, device=device)))
        return w

    def _obstacles_at(self, world: World, t) -> torch.Tensor:
        """Obstacle centres at episode step ``t`` (...,): (..., S, 3), the
        CircularPath position of count0 + t (physics/world.update_targets)."""
        t = torch.as_tensor(t)
        res = torch.clamp_min(world.sphere_path_res, 1)
        cnt = world.sphere_path_count + t[..., None]
        theta = (2.0 * math.pi) * (torch.remainder(cnt, res).to(self.dtype) / res.to(self.dtype))
        offset = torch.stack([torch.cos(theta) * world.sphere_path_radius,
                              torch.sin(theta) * world.sphere_path_radius,
                              torch.zeros_like(theta)], dim=-1)
        return torch.where(world.sphere_has_path[..., None], world.sphere_path_center + offset,
                           world.sphere_center)

    def _world_at(self, world: World, t) -> World:
        """The world the agents meet at step ``t`` (...,): obstacles advanced,
        with an agent axis before the sphere axis so the sphere fields
        broadcast against (..., A) agents."""
        if not self.n_obstacles:
            return world
        centers = self._obstacles_at(world, t)
        lead = centers.shape[:-2]
        return world.replace(
            sphere_center=centers[..., None, :, :],
            sphere_radius=world.sphere_radius.expand(lead + (1, world.num_spheres)),
            sphere_active=world.sphere_active.expand(lead + (1, world.num_spheres)))

    # ---- helpers ----------------------------------------------------------

    def _gate_info(self, world: World, next_gate, pos):
        """(signed plane distance, lateral offset, vector to the gate centre)."""
        idx = next_gate.long()
        gp = world.gate_pos[idx]  # (..., A, 3)
        normal = world.gate_rotmat[idx][..., :, 0]
        rel = pos - gp
        plane_d = torch.sum(rel * normal, dim=-1)
        lateral = torch.linalg.vector_norm(rel - plane_d[..., None] * normal, dim=-1)
        return plane_d, lateral, gp - pos

    def _rank(self, gates_passed, center_dist):
        """Race position per agent, 0 = leader: by gates passed, ties broken
        by the distance to the next gate's centre."""
        score = gates_passed.to(self.dtype) * 1e3 - center_dist
        return torch.sum(score[..., :, None] < score[..., None, :], dim=-1).to(torch.int32)

    def _others(self, pos):
        """(..., A, (A-1)*3): the other agents' positions relative to each."""
        A = self.n_agents
        rel_all = pos[..., None, :, :] - pos[..., :, None, :]
        idx = torch.tensor([[j for j in range(A) if j != i] for i in range(A)],
                           dtype=torch.long, device=pos.device).reshape(A, A - 1)
        rows = torch.arange(A, device=pos.device)[:, None]
        return rel_all[..., rows, idx, :].reshape(pos.shape[:-2] + (A, (A - 1) * 3))

    def _obs(self, state: MultiRaceState, world: World) -> torch.Tensor:
        d = state.drones
        att_flat = d.att.reshape(d.att.shape[:-2] + (9,)) if self.params.att_mode == "rotmat" \
            else d.att
        plane_d, lateral, to_gate = self._gate_info(world, state.next_gate, d.pos)
        others = self._others(d.pos)
        if not self.others_in_obs:
            others = torch.zeros_like(others)
        return torch.cat([d.pos, d.vel, att_flat, d.rates / self.params.max_rates,
                          d.thrust[..., None] / self.params.thrust_curve.max_force, to_gate,
                          plane_d[..., None], lateral[..., None], others],
                         dim=-1).to(self.dtype)

    @property
    def obs_dim(self) -> int:
        att = 4 if self.params.att_mode == "quat" else 9
        return 3 + 3 + att + 3 + 1 + 3 + 1 + 1 + (self.n_agents - 1) * 3

    # ---- reset ------------------------------------------------------------

    def _sample_drones(self, generator: torch.Generator, batch_shape, device) -> DroneState:
        A = self.n_agents
        batch = tuple(batch_shape)
        angles = torch.arange(A, dtype=self.dtype, device=device) / A * 2 * math.pi
        # the spawn ring lies wholly behind gate 0's plane (normal +y at y = 0),
        # so every agent's first crossing counts
        base = torch.stack([self.track_radius + torch.cos(angles) * self.spawn_radius,
                            -3.0 - self.spawn_radius + torch.sin(angles) * self.spawn_radius,
                            torch.full((A,), self.spawn_height, dtype=self.dtype,
                                       device=device)], dim=-1)
        base = base.expand(batch + (A, 3))
        if self.permute_spawns:
            u = torch.rand(batch + (A,), generator=generator, device=generator.device)
            perm = torch.argsort(u, dim=-1).to(device)
            base = torch.gather(base, -2, perm[..., None].expand(batch + (A, 3)))
        jitter = 0.3 * torch.randn(batch + (A, 3), generator=generator, dtype=self.dtype,
                                   device=generator.device).to(device)
        ypr = torch.zeros(batch + (A, 3), dtype=self.dtype, device=device)
        ypr[..., 2] = 90.0  # face +y
        return drone_reset(self.params, base + jitter, torch.zeros_like(ypr), ypr)

    def _fresh(self, generator: torch.Generator, world: World, batch_shape,
               part: Optional[Part] = None) -> MultiRaceState:
        device = world.gate_pos.device
        batch, A = tuple(batch_shape), self.n_agents
        drones = take_part(self._sample_drones(generator, draw_shape(batch, part), device), part)
        next_gate = torch.zeros(batch + (A,), dtype=torch.int32, device=device)
        plane_d, _, to_gate = self._gate_info(world, next_gate, drones.pos)
        gates0 = torch.zeros_like(next_gate)
        center_d0 = torch.linalg.vector_norm(to_gate, dim=-1)
        return MultiRaceState(
            drones=drones, next_gate=next_gate, prev_gate_dist=plane_d,
            prev_center_dist=center_d0, gates_passed=gates0,
            prev_rank=self._rank(gates0, center_d0),
            t=torch.zeros(batch, dtype=torch.int32, device=device),
            episode_return=torch.zeros(batch + (A,), dtype=self.dtype, device=device))

    def reset(self, generator: torch.Generator, world: Optional[World] = None, batch_shape=(),
              device=None):
        """``batch_shape`` fresh races and their observations; without a
        world the default track is built on ``device`` (CUDA unless told)."""
        world = self.default_world(device) if world is None else world
        state = self._fresh(generator, world, batch_shape)
        return state, self._obs(state, world)

    # ---- step -------------------------------------------------------------

    def step(self, state: MultiRaceState, actions, world: Optional[World] = None, wind=None,
             generator: Optional[torch.Generator] = None, part: Optional[Part] = None):
        """actions (..., A, 4). Returns (state, obs, reward (..., A), done
        (...,) per race, info). Races whose agents all crashed, or that
        reached ``max_episode_steps``, restart from draws of ``generator``
        (the default generator of the state's device when None). Under
        ``part`` the (races,) bank is one rank's slice of a larger bank: the
        reset draws are made at the whole bank's shape and sliced."""
        device = state.drones.pos.device
        world = self.default_world(device) if world is None else world
        actions = torch.as_tensor(actions, dtype=self.dtype, device=device)
        # obstacles move BEFORE the physics step (the reference's
        # target.update() -> drone.step() order): collisions see step t + 1
        drones, _ = drone_step(self.params, state.drones, actions,
                               self._world_at(world, state.t + 1), wind=wind)

        # contact between agents crashes both (pairwise centres)
        A = self.n_agents
        diff = drones.pos[..., None, :, :] - drones.pos[..., :, None, :]
        eye = torch.eye(A, dtype=self.dtype, device=device)[..., None] * 1e3
        pair_d = torch.linalg.vector_norm(diff + eye, dim=-1)
        contact = torch.any(pair_d < self.agent_collision_radius, dim=-1)
        crashed = drones.done | contact
        # the crash penalty falls on the transition: done stays set until
        # the race resets
        newly_crashed = crashed & ~state.drones.done
        drones = drones.replace(done=crashed)

        plane_d, lateral, to_gate = self._gate_info(world, state.next_gate, drones.pos)
        passed = ((state.prev_gate_dist < 0) & (plane_d >= 0)
                  & (lateral < world.gate_size[state.next_gate.long()] / 2.0) & ~crashed)
        next_gate = torch.where(passed, torch.remainder(state.next_gate + 1, self.n_gates),
                                state.next_gate)
        gates_passed = state.gates_passed + passed.to(torch.int32)
        plane_d_new, _, to_gate_new = self._gate_info(world, next_gate, drones.pos)
        center_d_new = torch.linalg.vector_norm(to_gate_new, dim=-1)

        # progress toward the next gate's CENTRE, bounded by the leg length
        center_d = torch.linalg.vector_norm(to_gate, dim=-1)
        progress = torch.where(passed, torch.zeros_like(center_d),
                               state.prev_center_dist - center_d)
        rank = self._rank(gates_passed, center_d_new)
        positions_gained = (state.prev_rank - rank).to(self.dtype)
        f = self.dtype
        reward = (self.w_gate * passed.to(f) + self.w_progress * progress.to(f)
                  + self.w_alive * (~crashed).to(f) - self.w_crash * newly_crashed.to(f)
                  + self.w_overtake * positions_gained)

        t = state.t + 1
        env_done = torch.all(crashed, dim=-1) | (t >= self.max_episode_steps)
        ep_ret = state.episode_return + reward
        next_state = MultiRaceState(
            drones=drones, next_gate=next_gate, prev_gate_dist=plane_d_new,
            prev_center_dist=center_d_new, gates_passed=gates_passed, prev_rank=rank, t=t,
            episode_return=ep_ret)

        if generator is None:
            generator = default_generator(device)
        reset_state = self._fresh(generator, world, tuple(env_done.shape), part)
        next_state = tree_where(env_done, reset_state, next_state)

        info = {
            "gates_passed": gates_passed,
            "crashed": crashed,
            # contact transitions and positions gained this step (the
            # per-agent counters of the multi-agent eval)
            "contact": contact & ~state.drones.done,
            "overtakes": torch.clamp_min(state.prev_rank - rank, 0).to(torch.int32),
            "episode_return": ep_ret,
        }
        return next_state, self._obs(next_state, world), reward, env_done, info


def make_shared_policy_env_step(env: MultiRaceEnv, world: Optional[World] = None,
                                n_envs: int = 64, device=None, part: Optional[Part] = None):
    """The race env for one shared-policy learner: the learner sees a flat
    (n_envs * n_agents) batch, and a race's reset ends every agent's episode.
    Returns (env_step, reset_fn) in ``rl.ppo.make_ppo``'s env_step contract:
    ``reset_fn(generator) -> (state, obs)``, ``env_step(state, action,
    generator) -> (state, obs, reward, done)``, all flat over agents.
    ``reset_fn`` builds all ``n_envs`` races; ``env_step`` steps the races
    ``part`` names (all of them when None), whole races a rank."""
    world = env.default_world(device) if world is None else world
    A = env.n_agents

    def reset_fn(generator: torch.Generator):
        state, obs = env.reset(generator, world, (n_envs,))
        return state, obs.reshape(n_envs * A, -1)

    def env_step(env_state, action, generator: torch.Generator):
        # race-major flat batch: any contiguous slice of it holds whole races
        actions = action.reshape(-1, A, action.shape[-1])
        st, obs, reward, done, info = env.step(env_state, actions, world, generator=generator,
                                               part=part)
        # an agent's own crash (absorbing) or the race's reset ends its episode
        done_flat = (info["crashed"] | done[:, None]).reshape(-1)
        return st, obs.reshape(obs.shape[0] * A, -1), reward.reshape(-1), done_flat

    return env_step, reset_fn
