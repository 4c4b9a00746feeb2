"""Soft Actor-Critic: the off-policy learner over the device replay
(mirrors ``fpyv_tpu.rl.sac``).

Twin Q critics with a target copy, a tanh-squashed Gaussian actor with the
change-of-variables log-prob correction, and a temperature tuned toward a
target entropy. One ``train_step`` = one env step on every env, its
transitions into the ring replay (:mod:`fpyv_tpu_torch.rl.replay`), then
``updates_per_step`` updates, each in the JAX update's order:

1. the critic, toward a TD target from the target critic, the old
   temperature and a next action sampled from the old actor (no gradient);
2. the actor, through the critic just updated: the critic's parameters are
   frozen around the actor loss, so its gradient reaches the actor alone
   and nothing lands in the critic's ``.grad``;
3. the temperature, from the actor loss's log-probs (detached);
4. the target critic, ``(1 - tau) * t + tau * s`` (as JAX writes it).

Where JAX threads immutable params, optax states and a PRNG key, the port
updates the modules, three ``torch.optim.Adam`` (optax's ``adam`` step for
step) and one ``torch.Generator`` held by :class:`SacState` in place and
returns a new ``SacState`` that holds them. Every draw goes through a
module-level function (``replay.replay_indices``, :func:`squash_noise`,
:func:`uniform_actions`), in the order: the action (warm-up uniform or
squashed sample), the env step's resets, then per update the sample's
indices, the next action's noise and the actor's noise. Each draws on the
generator's own device; the trainer gives it a generator on the training
device, so no draw is copied from the host (on CUDA a pageable copy waits
for the stream: three an update would be 24 an iteration).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from fpyv_tpu_torch.rl.replay import ReplayBuffer, replay_add_batch, replay_init, replay_sample


@dataclass(frozen=True)
class SacConfig:
    num_envs: int = 128
    buffer_capacity: int = 200_000
    batch_size: int = 256
    gamma: float = 0.99
    tau: float = 0.005  # target soft-update rate
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    alpha_lr: float = 3e-4
    target_entropy: Optional[float] = None  # default: -action_dim
    updates_per_step: int = 1


@dataclass
class SacState:
    actor: nn.Module  # the learner updates the three nets in place
    critic: nn.Module
    target_critic: nn.Module
    log_alpha: torch.Tensor  # () float32, a leaf with a gradient
    actor_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    alpha_opt: torch.optim.Optimizer
    buffer: ReplayBuffer
    env_state: Any
    last_obs: torch.Tensor
    generator: torch.Generator
    step: int

    def replace(self, **changes) -> "SacState":
        return dataclasses.replace(self, **changes)


LOG_2 = 0.6931471805599453
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def squash_noise(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """Standard normal noise for a squashed sample."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def uniform_actions(shape, generator: torch.Generator, dtype, device) -> torch.Tensor:
    """The warm-up's actions, uniform over [-1, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return (-1.0 + u * 2.0).to(device)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|))``; ``torch.nn.functional.softplus`` returns x itself
    above its threshold and rounds otherwise below it."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _squashed_sample(actor: Callable, obs: torch.Tensor,
                     noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a = tanh(u), u = mean + std * noise, (mean, log_std) = actor(obs);
    returns (a, log_prob(a)), the Gaussian log-density less ``sum log(1 -
    tanh(u)^2)`` in its stable form ``2 (log 2 - u - softplus(-2u))``."""
    mean, log_std = actor(obs)
    std = torch.exp(log_std)
    u = mean + std * noise
    a = torch.tanh(u)
    log_prob = torch.sum(-0.5 * ((u - mean) / std) ** 2 - log_std - _HALF_LOG_2PI, dim=-1)
    log_prob = log_prob - torch.sum(2.0 * (LOG_2 - u - _softplus(-2.0 * u)), dim=-1)
    return a, log_prob


@contextlib.contextmanager
def _frozen(module: nn.Module):
    """The module's parameters take no gradient inside the scope."""
    flags = [p.requires_grad for p in module.parameters()]
    module.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in zip(module.parameters(), flags):
            p.requires_grad_(flag)


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()


def make_sac(
    env_step: Callable,  # (env_state, action, generator) -> (env_state, obs, r, d)
    #   or -> (..., d, store_next_obs): the optional 5th is the successor obs
    #   to STORE in the replay (the pre-reset obs at time-limit truncations,
    #   so the Q target bootstraps from the true successor, not the respawn)
    config: SacConfig,
    obs_dim: int,
    action_dim: int,
):
    """Build ``(init, train_step)``.

    ``init(actor, critic, env_state, obs0, generator) -> SacState``: the
    actor maps obs to (mean, log_std), the critic (obs, action) to (q1, q2);
    the
    target critic starts as a copy of the critic, ``log_alpha`` at 0, the
    replay on ``obs0``'s device. ``train_step(state, random_actions=False)
    -> (state, metrics)``: metrics ``critic_loss``, ``actor_loss``,
    ``alpha``, ``entropy`` (of the last update) and ``mean_reward``, device
    tensors.
    """
    target_entropy = (config.target_entropy if config.target_entropy is not None
                      else -float(action_dim))

    def init(actor: nn.Module, critic: nn.Module, env_state, obs0: torch.Tensor,
             generator: torch.Generator) -> SacState:
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.zeros((), dtype=torch.float32, device=obs0.device, requires_grad=True)
        return SacState(
            actor=actor, critic=critic, target_critic=target, log_alpha=log_alpha,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=config.actor_lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=config.critic_lr),
            alpha_opt=torch.optim.Adam([log_alpha], lr=config.alpha_lr),
            buffer=replay_init(config.buffer_capacity, obs_dim, action_dim,
                               device=obs0.device),
            env_state=env_state, last_obs=obs0, generator=generator, step=0)

    def _noise(like: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        return squash_noise(tuple(like.shape[:-1]) + (action_dim,), gen, like.dtype, like.device)

    def _update(state: SacState) -> Tuple[SacState, Dict[str, torch.Tensor]]:
        gen = state.generator
        obs, action, reward, next_obs, done = replay_sample(state.buffer, gen, config.batch_size)
        alpha = torch.exp(state.log_alpha.detach())

        # critic: TD target with the entropy bonus, from the old actor
        with torch.no_grad():
            next_a, next_logp = _squashed_sample(state.actor, next_obs, _noise(next_obs, gen))
            tq1, tq2 = state.target_critic(next_obs, next_a)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = reward + config.gamma * (1.0 - done) * target_v
        q1, q2 = state.critic(obs, action)
        c_loss = torch.mean((q1 - target_q) ** 2 + (q2 - target_q) ** 2)
        _step(state.critic_opt, c_loss)

        # actor, through the updated critic
        with _frozen(state.critic):
            a, logp = _squashed_sample(state.actor, obs, _noise(obs, gen))
            q1, q2 = state.critic(obs, a)
            a_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
            _step(state.actor_opt, a_loss)
        logp = logp.detach()

        # temperature
        _step(state.alpha_opt, -torch.mean(torch.exp(state.log_alpha) * (logp + target_entropy)))

        # target soft update
        with torch.no_grad():
            targets = list(state.target_critic.parameters())
            torch._foreach_mul_(targets, 1.0 - config.tau)
            torch._foreach_add_(targets, torch._foreach_mul(
                [p.detach() for p in state.critic.parameters()], config.tau))

        metrics = {"critic_loss": c_loss.detach(), "actor_loss": a_loss.detach(),
                   "alpha": torch.exp(state.log_alpha.detach()), "entropy": -torch.mean(logp)}
        return state, metrics

    def train_step(state: SacState, random_actions: bool = False):
        """One env step on all envs + ``updates_per_step`` updates."""
        gen, obs = state.generator, state.last_obs
        with torch.no_grad():
            if random_actions:  # warm-up exploration
                action = uniform_actions(tuple(obs.shape[:-1]) + (action_dim,), gen, obs.dtype,
                                         obs.device)
            else:
                action, _ = _squashed_sample(state.actor, obs, _noise(obs, gen))
            out = env_step(state.env_state, action, gen)
        if len(out) == 5:  # (st, obs, r, d, store_next_obs)
            env_state, next_obs, reward, done, store_obs = out
        else:
            env_state, next_obs, reward, done = out
            store_obs = next_obs
        buffer = replay_add_batch(state.buffer, obs, action, reward, store_obs, done)
        state = state.replace(buffer=buffer, env_state=env_state, last_obs=next_obs,
                              step=state.step + 1)
        metrics = {}
        for _ in range(config.updates_per_step):
            state, metrics = _update(state)
        metrics["mean_reward"] = reward.mean()
        return state, metrics

    return init, train_step
