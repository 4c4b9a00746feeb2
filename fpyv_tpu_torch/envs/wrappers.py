"""Env wrappers: observation normalization, frame stacking, action shaping,
policy evaluation (mirrors ``fpyv_tpu.envs.wrappers``).

Standard RL plumbing the reference lacks; every wrapper is a function of
state dataclasses and tensors, as the envs are.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from fpyv_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Running observation normalization (Welford across the batch per step)
# ---------------------------------------------------------------------------


@dataclass
class ObsNormState:
    mean: torch.Tensor  # (O,)
    var: torch.Tensor  # (O,)
    count: torch.Tensor  # ()

    def replace(self, **changes) -> "ObsNormState":
        return dataclasses.replace(self, **changes)


def obs_norm_init(obs_dim: int, dtype=torch.float32, device=None) -> ObsNormState:
    """Zero mean, unit variance, a count of 1e-4, on ``device`` (CUDA
    unless told)."""
    kw = dict(dtype=dtype, device=resolve_device(device))
    return ObsNormState(mean=torch.zeros(obs_dim, **kw), var=torch.ones(obs_dim, **kw),
                        count=torch.tensor(1e-4, **kw))


def obs_norm_update(state: ObsNormState, obs: torch.Tensor) -> ObsNormState:
    """Fold a (N, O) batch into the running mean/var (parallel Welford;
    the batch's population variance, as ``jnp.var``)."""
    batch_mean = obs.mean(0)
    batch_var = obs.var(0, correction=0)
    batch_count = torch.tensor(obs.shape[0], dtype=state.count.dtype, device=state.count.device)
    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m2 = state.var * state.count + batch_var * batch_count + delta ** 2 * state.count \
        * batch_count / tot
    return ObsNormState(mean=new_mean, var=m2 / tot, count=tot)


def obs_norm_apply(state: ObsNormState, obs: torch.Tensor, clip: float = 10.0) -> torch.Tensor:
    return torch.clamp((obs - state.mean) / torch.sqrt(state.var + 1e-8), -clip, clip)


# ---------------------------------------------------------------------------
# Frame stacking (for pixel observations)
# ---------------------------------------------------------------------------


@dataclass
class FrameStackState:
    frames: torch.Tensor  # (..., K, H, W)

    def replace(self, **changes) -> "FrameStackState":
        return dataclasses.replace(self, **changes)


def _repeated(frame: torch.Tensor, k: int) -> torch.Tensor:
    return frame[..., None, :, :].expand(frame.shape[:-2] + (k,) + frame.shape[-2:]).clone()


def frame_stack_init(first_frame: torch.Tensor, k: int = 4) -> FrameStackState:
    """Fill the stack with the first frame (standard warm-up)."""
    return FrameStackState(frames=_repeated(first_frame, k))


def frame_stack_push(state: FrameStackState, frame: torch.Tensor) -> FrameStackState:
    return FrameStackState(frames=torch.cat([state.frames[..., 1:, :, :], frame[..., None, :, :]],
                                            dim=-3))


def frame_stack_reset_where(state: FrameStackState, done: torch.Tensor,
                            frame: torch.Tensor) -> FrameStackState:
    """On an env's auto-reset, refill that env's stack with its new first frame."""
    refilled = _repeated(frame, state.frames.shape[-3])
    return FrameStackState(frames=torch.where(done[..., None, None, None], refilled,
                                              state.frames))


# ---------------------------------------------------------------------------
# Action shaping
# ---------------------------------------------------------------------------


def squash_action(a: torch.Tensor) -> torch.Tensor:
    """tanh squash into the env's [-1, 1] action box."""
    return torch.tanh(a)


def scale_action(a: torch.Tensor, low, high) -> torch.Tensor:
    """[-1, 1] -> [low, high] per dimension."""
    low = torch.as_tensor(low, dtype=a.dtype, device=a.device)
    high = torch.as_tensor(high, dtype=a.dtype, device=a.device)
    return low + (a + 1.0) * 0.5 * (high - low)


# ---------------------------------------------------------------------------
# Policy evaluation
# ---------------------------------------------------------------------------


def evaluate_policy(env, world, policy_fn: Callable, generator: torch.Generator, n_envs: int,
                    n_steps: int, device=None) -> dict:
    """Deterministic evaluation rollout: aggregate episode statistics, as
    0-d tensors on the envs' device.

    One batched reset of ``n_envs`` envs (``world`` bound as the env's
    positional argument, none when it is None; the default world built on
    ``device``, CUDA unless told), then ``n_steps`` batched steps of
    ``policy_fn(obs) -> actions`` (no sampling: pass the mean action) with
    the env's auto-reset, its draws from ``generator``.
    """
    device = resolve_device(device)
    args = () if world is None else (world,)
    state, obs = env.reset(generator, *args, batch_shape=(n_envs,), device=device)
    rewards, dones = [], []
    for _ in range(n_steps):
        state, obs, reward, done, _ = env.step(state, policy_fn(obs), *args, generator=generator)
        rewards.append(reward)
        dones.append(done)
    rewards, dones = torch.stack(rewards), torch.stack(dones)
    total = dones.sum()
    return {
        "mean_step_reward": rewards.mean(),
        "total_episodes": total,
        "crash_rate_per_step": dones.to(rewards.dtype).mean(),
        "reward_per_episode_lower_bound": rewards.sum() / torch.clamp_min(total, 1),
    }
