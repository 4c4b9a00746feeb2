"""Attitude-alignment env: rotate the body to a goal orientation (mirrors
``fpyv_tpu.envs.rotate``).

- obs: the goal and current rotation matrices stacked on the last axis,
  (..., 3, 3, 2), goal first;
- action: (..., 3) in [-1, 1], scaled to body rates (deg/s) by ``max_rates``;
- dynamics: ``R_current <- rotate_body_by_rates(R_current, rates, dt)``;
- reward: ``-((R_goalᵀ R_current - I)²).sum()``, the product written out
  elementwise in float32 (no TF32 matmul on the card);
- done: the error below ``threshold``; the env then restarts (``auto_reset``);
- reset: goal Euler angles ~ U(0, 2π)³, current = (goal + N(0,
  difficulty)) mod 2π.

``noise_lvl_deg > 0`` adds the reference's gyro noise before each step,
``current <- E(deg2rad(N(0, σ)³ mod 2π)) @ current``, with its quirk of
taking ``mod 2π`` of a value in degrees.

As the port's ``AcroEnv``, the batch dimension is written out and the draws
come from a ``torch.Generator`` (through :func:`reset_draws` and
:func:`gyro_noise`, which the tests replace with JAX's draws); the state has
no ``key`` field.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.sensors.gyro import mod_two_pi


@dataclass
class RotateState:
    goal: torch.Tensor  # (..., 3, 3)
    current: torch.Tensor  # (..., 3, 3)
    done: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "RotateState":
        return dataclasses.replace(self, **changes)


def reset_draws(generator: torch.Generator, batch_shape, dtype, device):
    """A reset's draws: the goal's Euler angles U(0, 2π) and the offset's
    standard normal, each (*batch_shape, 3)."""
    shape = tuple(batch_shape) + (3,)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=generator.device)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    n = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return (u * two_pi).to(device), n.to(device)


def gyro_noise(generator: torch.Generator, batch_shape, dtype, device) -> torch.Tensor:
    """A step's gyro noise draw, standard normal, (*batch_shape, 3)."""
    return torch.randn(tuple(batch_shape) + (3,), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


@dataclass(frozen=True)
class RotateEnv:
    dt: float = 1e-2
    max_rates: float = 1000.0  # deg/s
    threshold: float = 1e-3
    difficulty: float = 1.0
    noise_lvl_deg: float = 0.0  # gyro noise σ in degrees (0 disables)
    auto_reset: bool = True
    dtype: torch.dtype = torch.float32

    def _sample(self, generator, batch_shape, device, part: Optional[Part] = None):
        euler_goal, n = take_part(
            reset_draws(generator, draw_shape(batch_shape, part), self.dtype, device), part)
        euler_current = mod_two_pi(euler_goal + self.difficulty * n)
        return rot.euler_to_rotmat(euler_goal), rot.euler_to_rotmat(euler_current)

    def reset(self, generator: torch.Generator, batch_shape=(), device=None,
              part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs on ``device`` (CUDA unless
        told) and its observation; under ``part`` the bank is one rank's
        slice of a larger bank, its draws made at the whole bank's shape and
        sliced."""
        device = resolve_device(device)
        goal, current = self._sample(generator, batch_shape, device, part)
        state = RotateState(goal=goal, current=current,
                            done=torch.zeros(tuple(batch_shape), dtype=torch.bool, device=device))
        return state, self._obs(state)

    def _obs(self, state: RotateState) -> torch.Tensor:
        return torch.stack([state.goal, state.current], dim=-1)

    def _error(self, goal: torch.Tensor, current: torch.Tensor) -> torch.Tensor:
        rel = rot.mat3_mul(goal.transpose(-1, -2), current)  # R_gᵀ R_c
        eye = torch.eye(3, dtype=rel.dtype, device=rel.device)
        return torch.sum((rel - eye) ** 2, dim=(-2, -1))

    def step(self, state: RotateState, action, generator: Optional[torch.Generator] = None,
             reset_shape=None, part: Optional[Part] = None):
        """Returns (state, obs, reward, done, info). With ``auto_reset`` the
        envs that reach the goal restart from draws of ``generator`` (the
        default generator of the state's device when None) of batch shape
        ``reset_shape`` (the bank's when None): a trailing part of the
        bank's shape shares each draw across the leading axes. Under
        ``part`` the bank is one rank's slice of a larger bank: the
        bank-shaped draws (the gyro noise, the resets without
        ``reset_shape``) are made at the whole bank's shape and sliced."""
        device = state.current.device
        if generator is None:
            generator = default_generator(device)
        action = torch.as_tensor(action, dtype=self.dtype, device=device)
        current = state.current
        batch = tuple(current.shape[:-2])
        if self.noise_lvl_deg > 0.0:
            noise_deg = self.noise_lvl_deg * take_part(
                gyro_noise(generator, draw_shape(batch, part), self.dtype, device), part)
            # the reference's quirk: mod 2π taken of degrees
            noise = torch.deg2rad(mod_two_pi(noise_deg))
            current = rot.mat3_mul(rot.euler_to_rotmat(noise), current)

        current = rot.rotate_body_by_rates(current, action * self.max_rates, self.dt)
        err = self._error(state.goal, current)
        reward = -err
        done = err < self.threshold

        next_state = state.replace(current=current, done=done)
        if self.auto_reset:
            goal_r, current_r = (self._sample(generator, batch, device, part)
                                 if reset_shape is None
                                 else self._sample(generator, reset_shape, device))
            reset_state = RotateState(goal=goal_r, current=current_r,
                                      done=torch.zeros_like(done))
            next_state = tree_where(done, reset_state, next_state)
        return next_state, self._obs(next_state), reward, done, {"error": err}
