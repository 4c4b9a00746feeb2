"""Acro-mode drone env over batched tensors (mirrors ``fpyv_tpu.envs.acro``).

The vectorized rebuild of the reference's sim loop (simulator.py:83-177):
full drone physics, a shared SoA world (targets on circular paths,
cylinders, ground), random resets, per-env domain randomization and wind,
auto-reset on crash or truncation, and the target-chase reward
``w_progress·(prev_dist − dist) + w_alive − w_crash·crashed − w_rates·|a_rates|²``.

Where the JAX env vmaps one env over a batch of PRNG keys, this one writes
the batch dimension out and draws from an explicit ``torch.Generator``; the
state has no ``key`` field. The random streams therefore differ from the
JAX env's, so trajectories agree only until the first reset.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where
from fpyv_tpu_torch.physics.drone import (
    DomainRand,
    DroneParams,
    DroneState,
    drone_reset,
    drone_step,
)
from fpyv_tpu_torch.physics.world import World, empty_world, update_targets


@dataclass
class AcroState:
    drone: DroneState
    domain_rand: DomainRand
    t: torch.Tensor  # (...,) int32 steps since episode start
    prev_dist: torch.Tensor  # (...,) distance to the chased target at the previous step
    episode_return: torch.Tensor  # (...,) running return (metrics)
    wind: torch.Tensor  # (..., 3) world-frame wind, resampled at reset

    def replace(self, **changes) -> "AcroState":
        return dataclasses.replace(self, **changes)


def _uniform(generator, shape, low, high, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    low = torch.as_tensor(low, dtype=dtype, device=generator.device)
    high = torch.as_tensor(high, dtype=dtype, device=generator.device)
    return (low + u * (high - low)).to(device)


def _normal(generator, shape, dtype, device):
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


@dataclass(frozen=True)
class AcroEnv:
    params: DroneParams = field(default_factory=DroneParams)
    pos_low: Tuple[float, float, float] = (-5.0, -5.0, 4.0)
    pos_high: Tuple[float, float, float] = (5.0, 5.0, 12.0)
    vel_scale: float = 1.0
    ypr_range_deg: float = 30.0
    max_episode_steps: int = 1000
    w_progress: float = 1.0
    w_alive: float = 0.01
    w_crash: float = 10.0
    w_rates: float = 0.0001
    randomize: bool = False
    mass_range: Tuple[float, float] = (0.8, 1.2)
    drag_range: Tuple[float, float] = (0.7, 1.3)
    thrust_range: Tuple[float, float] = (0.85, 1.15)
    wind: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    wind_scale: float = 0.0
    dtype: torch.dtype = torch.float32

    # ---- world ------------------------------------------------------------

    def default_world(self, device=None) -> World:
        """One target circling at radius 25 over ground (params.yaml targets block)."""
        device = resolve_device(device)
        w = empty_world(n_spheres=1, n_cylinders=0, ground=True, dtype=self.dtype,
                        device=device)
        kw = dict(dtype=self.dtype, device=device)
        center = torch.tensor([0.0, 0.0, 3.0], **kw)
        return w.replace(
            sphere_center=center[None, :].clone(),
            sphere_radius=torch.tensor([1.0], **kw),
            sphere_path_center=center[None, :].clone(),
            sphere_path_radius=torch.tensor([25.0], **kw),
            sphere_path_res=torch.tensor([5500], dtype=torch.int32, device=device),
            sphere_has_path=torch.tensor([True], device=device),
        )

    # ---- obs --------------------------------------------------------------

    @property
    def obs_dim(self) -> int:
        att = 9 if self.params.att_mode == "rotmat" else 4
        return 3 + 3 + att + 3 + 1 + 3  # pos vel att rates thrust rel_target

    def _obs(self, state: AcroState, world: World) -> torch.Tensor:
        d = state.drone
        att_flat = (d.att.reshape(d.att.shape[:-2] + (9,))
                    if self.params.att_mode == "rotmat" else d.att)
        rel = world.sphere_center[..., 0, :] - d.pos
        return torch.cat([
            d.pos, d.vel, att_flat,
            d.rates / self.params.max_rates,
            d.thrust[..., None] / self.params.thrust_curve.max_force,
            rel,
        ], dim=-1).to(self.dtype)

    # ---- reset ------------------------------------------------------------

    def _sample_drone(self, generator, batch_shape, device) -> DroneState:
        shape = tuple(batch_shape) + (3,)
        pos = _uniform(generator, shape, self.pos_low, self.pos_high, self.dtype, device)
        vel = self.vel_scale * _normal(generator, shape, self.dtype, device)
        ypr = _uniform(generator, shape, -self.ypr_range_deg, self.ypr_range_deg,
                       self.dtype, device)
        return drone_reset(self.params, pos, vel, ypr)

    def _sample_dr(self, generator, batch_shape, device) -> DomainRand:
        if not self.randomize:
            return DomainRand.nominal(batch_shape, self.dtype, device)
        return DomainRand.sample(generator, batch_shape, self.mass_range, self.drag_range,
                                 self.thrust_range, self.dtype, device)

    def _sample_wind(self, generator, batch_shape, device) -> torch.Tensor:
        shape = tuple(batch_shape) + (3,)
        base = torch.tensor(self.wind, dtype=self.dtype, device=device).expand(shape)
        if self.wind_scale <= 0.0:
            return base.clone()
        return base + self.wind_scale * _normal(generator, shape, self.dtype, device)

    def _fresh(self, generator, world: World, batch_shape,
               part: Optional[Part] = None) -> AcroState:
        device = world.sphere_center.device
        shape = draw_shape(batch_shape, part)
        drone = self._sample_drone(generator, shape, device)
        dr = self._sample_dr(generator, shape, device)
        wind = self._sample_wind(generator, shape, device)
        drone, dr, wind = take_part((drone, dr, wind), part)
        target = world.sphere_center[..., 0, :]
        return AcroState(
            drone=drone,
            domain_rand=dr,
            t=torch.zeros(tuple(batch_shape), dtype=torch.int32, device=device),
            prev_dist=torch.linalg.vector_norm(target - drone.pos, dim=-1),
            episode_return=torch.zeros(tuple(batch_shape), dtype=self.dtype, device=device),
            wind=wind,
        )

    def reset(self, generator: torch.Generator, world: Optional[World] = None,
              batch_shape=(), device=None, part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs and its observation. Without a
        world, the default world is built on ``device`` (CUDA unless told).
        Under ``part`` the bank is one rank's slice of a larger bank: the
        draws are made at the whole bank's shape and sliced."""
        world = self.default_world(device) if world is None else world
        state = self._fresh(generator, world, batch_shape, part)
        return state, self._obs(state, world)

    # ---- step -------------------------------------------------------------

    def step(self, state: AcroState, action, world: Optional[World] = None,
             wind: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, reset_shape=None,
             part: Optional[Part] = None):
        """Returns (state, obs, reward, done, info). Envs that crash or reach
        ``max_episode_steps`` restart from draws of ``generator`` (the
        default generator of the state's device when None) of batch shape
        ``reset_shape`` (the bank's when None): a trailing part of the
        bank's shape shares each draw across the leading axes (the ES
        fitness's common random numbers). Under ``part`` the bank is one
        rank's slice of a larger bank, and the bank-shaped reset draws are
        made at the whole bank's shape and sliced."""
        world = self.default_world(state.drone.pos.device) if world is None else world
        action = torch.as_tensor(action, dtype=self.dtype, device=state.drone.pos.device)
        drone, imu = drone_step(self.params, state.drone, action, world,
                                wind=state.wind if wind is None else wind,
                                domain_rand=state.domain_rand)
        target = world.sphere_center[..., 0, :]
        dist = torch.linalg.vector_norm(target - drone.pos, dim=-1)

        crashed = drone.done
        truncated = state.t + 1 >= self.max_episode_steps
        done = crashed | truncated

        progress = state.prev_dist - dist
        rates_pen = (action[..., :3] ** 2).sum(-1)
        reward = (self.w_progress * progress + self.w_alive
                  - self.w_crash * crashed.to(self.dtype)
                  - self.w_rates * rates_pen).to(self.dtype)

        ep_ret = state.episode_return + reward
        live_state = state.replace(drone=drone, t=state.t + 1, prev_dist=dist,
                                   episode_return=ep_ret)

        if generator is None:
            generator = default_generator(drone.pos.device)
        reset_state = (self._fresh(generator, world, tuple(done.shape), part)
                       if reset_shape is None else self._fresh(generator, world, reset_shape))
        next_state = tree_where(done, reset_state, live_state)

        info = {
            "crashed": crashed,
            "truncated": truncated,
            "dist_to_target": dist,
            "episode_return": ep_ret,
            "imu": imu,
            "final_obs": self._obs(live_state, world),
        }
        return next_state, self._obs(next_state, world), reward, done, info


# ---------------------------------------------------------------------------
# Vectorized rollout helpers
# ---------------------------------------------------------------------------


def vector_reset(env: AcroEnv, generator: torch.Generator, n_envs: int,
                 world: Optional[World] = None, device=None):
    return env.reset(generator, world, batch_shape=(n_envs,), device=device)


def vector_step(env: AcroEnv, state: AcroState, actions, world: Optional[World] = None,
                generator: Optional[torch.Generator] = None):
    """One step of a bank of envs. JAX vmaps its single-env step here; the
    port's ``step`` is already batched, so this is ``env.step`` itself."""
    return env.step(state, actions, world, generator=generator)


def rollout(env: AcroEnv, state: AcroState, world: World, policy_fn, steps: int,
            move_targets: bool = True, generator: Optional[torch.Generator] = None):
    """A Python loop over steps: ``policy_fn(obs) -> actions``. Targets
    advance once per step (simulator.py:87). Returns (state, world,
    rewards (steps, N), dones (steps, N))."""
    rewards, dones = [], []
    for _ in range(steps):
        if move_targets:
            world = update_targets(world)
        actions = policy_fn(env._obs(state, world))
        state, _, reward, done, _ = env.step(state, actions, world, generator=generator)
        rewards.append(reward)
        dones.append(done)
    return state, world, torch.stack(rewards), torch.stack(dones)
