"""Distance-only navigation env + proportional-navigation agent (mirrors
``fpyv_tpu.envs.ball``).

Reference parity (tests/find_by_distance.py:6-69):

- state: a 2D ball position; goal U(-1,1)²; the ONLY observation is the
  scalar distance to the goal (:24) — a UWB-style range sensor task;
- action: (2,) in [-1,1], applied as a position delta (:28);
- reward = -distance; done when distance < 0.1 (:30-31);
- ``ProportionalNavigation`` (:43-69): steer from consecutive range
  readings only.

The batch dimension is written out; the draws come from a
``torch.Generator`` through :func:`reset_draws` and :func:`random_actions`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where


def _uniform_pm1(generator: torch.Generator, shape, dtype, device) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype, device=generator.device)
    return (u * 2.0 - 1.0).to(device)


def reset_draws(generator: torch.Generator, batch_shape, dtype, device):
    """A reset's draws: the position, then the goal, each U(-1, 1),
    (*batch_shape, 2)."""
    shape = tuple(batch_shape) + (2,)
    pos = _uniform_pm1(generator, shape, dtype, device)
    return pos, _uniform_pm1(generator, shape, dtype, device)


def random_actions(generator: torch.Generator, batch_shape, dtype, device) -> torch.Tensor:
    """The agent's first-step action draw, U(-1, 1), (*batch_shape, 2)."""
    return _uniform_pm1(generator, tuple(batch_shape) + (2,), dtype, device)


@dataclass
class BallState:
    pos: torch.Tensor  # (..., 2)
    goal: torch.Tensor  # (..., 2)
    done: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "BallState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class BallEnv:
    threshold: float = 0.1
    auto_reset: bool = True
    dtype: torch.dtype = torch.float32

    def _sample(self, generator, batch_shape, device, part: Optional[Part] = None):
        return take_part(reset_draws(generator, draw_shape(batch_shape, part), self.dtype,
                                     device), part)

    def _obs(self, pos: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        return torch.linalg.vector_norm(pos - goal, dim=-1)

    def reset(self, generator: torch.Generator, batch_shape=(), device=None,
              part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs on ``device`` (CUDA unless
        told) and its observation (the distance to the goal)."""
        device = resolve_device(device)
        pos, goal = self._sample(generator, batch_shape, device, part)
        state = BallState(pos=pos, goal=goal,
                          done=torch.zeros(tuple(batch_shape), dtype=torch.bool, device=device))
        return state, self._obs(pos, goal)

    def step(self, state: BallState, action, generator: Optional[torch.Generator] = None,
             part: Optional[Part] = None):
        """Returns (state, obs, reward, done, info). With ``auto_reset`` the
        envs within ``threshold`` of their goal restart from draws of
        ``generator`` (the default generator of the state's device when
        None)."""
        device = state.pos.device
        pos = state.pos + torch.as_tensor(action, dtype=self.dtype, device=device)
        obs = self._obs(pos, state.goal)
        done = obs < self.threshold
        next_state = state.replace(pos=pos, done=done)
        if self.auto_reset:
            generator = default_generator(device) if generator is None else generator
            pos_r, goal_r = self._sample(generator, tuple(done.shape), device, part)
            reset_state = BallState(pos=pos_r, goal=goal_r, done=torch.zeros_like(done))
            next_state = tree_where(done, reset_state, next_state)
        return next_state, self._obs(next_state.pos, next_state.goal), -obs, done, {}


@dataclass
class PropNavState:
    prev_obs: torch.Tensor  # (...,) previous range reading
    has_prev: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "PropNavState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ProportionalNavigation:
    """Range-only steering (tests/find_by_distance.py:43-69), vectorized.

    On the first step the reference samples a random action; after that:
    ``a = clip(|d| · sign(d - d_prev), -1, 1)`` on both axes. The random
    action is drawn at every step, as in JAX, and used on the first.
    """

    def init(self, batch_shape=(), dtype=torch.float32, device=None) -> PropNavState:
        device = resolve_device(device)
        return PropNavState(prev_obs=torch.zeros(tuple(batch_shape), dtype=dtype, device=device),
                            has_prev=torch.zeros(tuple(batch_shape), dtype=torch.bool,
                                                 device=device))

    def act(self, state: PropNavState, obs: torch.Tensor, generator: torch.Generator,
            part: Optional[Part] = None):
        course = obs.abs() * torch.sign(obs - state.prev_obs)
        steered = torch.clamp(course, -1.0, 1.0)[..., None].expand(obs.shape + (2,))
        random_a = take_part(random_actions(generator, draw_shape(obs.shape, part), obs.dtype,
                                            obs.device), part)
        action = torch.where(state.has_prev[..., None], steered, random_a)
        return PropNavState(prev_obs=obs, has_prev=torch.ones_like(state.has_prev)), action
