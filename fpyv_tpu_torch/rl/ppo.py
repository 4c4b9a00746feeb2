"""PPO: clipped-surrogate actor-critic over vectorized env rollouts
(mirrors ``fpyv_tpu.rl.ppo``).

One ``train_iteration`` = a T-step rollout over N envs (the default per-step
loop, or a ``rollout_fn`` such as the in-kernel vision rollout), GAE, then E
epochs of minibatched Adam updates with global-norm clipping. The learner is
plain PyTorch (autograd through ``nn.Module``s); the JAX package computes it
in XLA outside any Pallas kernel.

Where JAX threads immutable params, optimizer state and a PRNG key through
the iteration, the port updates the module, the ``torch.optim.Adam`` and the
``torch.Generator`` held by :class:`PpoState` in place and returns a new
``PpoState`` that holds them. ``scan_train`` is a host loop.

Matching optax: ``optax.clip_by_global_norm`` scales by ``max_norm / norm``
with no epsilon (``clip_grad_norm_`` adds 1e-6, so the rule is written out);
``optax.adam(lr, eps=1e-5)`` is ``torch.optim.Adam(lr=lr, eps=1e-5)``; the
advantage std is the population std (``correction=0``).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from fpyv_tpu_torch.rl.gae import compute_gae


@dataclass(frozen=True)
class PpoConfig:
    num_envs: int = 4096
    num_steps: int = 32  # T per rollout
    update_epochs: int = 4
    num_minibatches: int = 8
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    ent_coef: float = 0.001
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    learning_rate: float = 3e-4
    # Adam first-moment dtype: None = float32; "bf16" is not ported yet
    adam_mu_dtype: Optional[str] = None
    # shuffle granularity in rows of the flattened (T*N) batch: blocks of
    # consecutive rows (the same timestep across `shuffle_block` envs) move
    # together
    shuffle_block: int = 64

    def __post_init__(self):
        if self.adam_mu_dtype is not None:
            raise ValueError(f"adam_mu_dtype={self.adam_mu_dtype!r} is not ported yet "
                             "(ROADMAP queue 1); use None (float32)")


@dataclass
class PpoState:
    params: torch.nn.Module  # the policy; the learner updates it in place
    opt_state: torch.optim.Optimizer
    env_state: Any
    last_obs: Any
    generator: torch.Generator  # shuffles, action noise, kernel seeds
    update_count: int

    def replace(self, **changes) -> "PpoState":
        return dataclasses.replace(self, **changes)


@dataclass
class Transition:
    obs: Any
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_HALF_LOG_2PIE = 0.5 * math.log(2.0 * math.pi * math.e)


def gaussian_log_prob(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - _HALF_LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + _HALF_LOG_2PIE, dim=-1)


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: fn(v) for k, v in x.items()}
    return fn(x)


def _leading(x) -> int:
    return (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's rule: when the global norm reaches ``max_norm``, every
    gradient becomes ``(g / norm) * max_norm``. Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, (g / norm) * max_norm))
    return norm


def make_step_rollout(apply_fn: Callable, env_step: Callable, config: PpoConfig):
    """``make_ppo``'s default rollout: T steps of the policy and
    ``env_step``, one at a time, the action noise drawn from
    ``state.generator``. ``rollout(state) -> (env_state, last_obs, traj)``,
    traj a (T, N, ...) Transition."""

    @torch.no_grad()
    def rollout(state: PpoState):
        env_state, obs, steps = state.env_state, state.last_obs, []
        for _ in range(config.num_steps):
            mean, log_std, value = apply_fn(state.params, obs)
            noise = torch.randn(mean.shape, generator=state.generator, dtype=mean.dtype,
                                device=state.generator.device).to(mean.device)
            action = mean + torch.exp(log_std) * noise
            log_prob = gaussian_log_prob(mean, log_std, action)
            env_state, next_obs, reward, done = env_step(env_state, action, state.generator)
            steps.append(Transition(obs=obs, action=action, log_prob=log_prob, value=value,
                                    reward=reward, done=done))
            obs = next_obs

        def stack(name):
            vals = [getattr(t, name) for t in steps]
            if isinstance(vals[0], dict):
                return {k: torch.stack([v[k] for v in vals]) for k in vals[0]}
            return torch.stack(vals)

        traj = Transition(**{f.name: stack(f.name) for f in dataclasses.fields(Transition)})
        return env_state, obs, traj

    return rollout


def make_ppo(
    apply_fn: Callable,  # apply_fn(params, obs) -> (mean, log_std, value)
    env_step: Optional[Callable],  # env_step(env_state, action, generator)
    #   -> (env_state, obs, reward, done)
    config: PpoConfig,
    metrics_fn: Optional[Callable] = None,  # metrics_fn(env_state) -> dict
    rollout_fn: Optional[Callable] = None,  # replaces the default per-step
    #   rollout: rollout_fn(state) -> (env_state, last_obs, traj), traj a
    #   (T, N, ...) Transition; it draws from state.generator
):
    """Build (init, train_iteration) for a vectorized env.

    ``env_step`` steps the whole env bank with auto-reset inside it:
    actions (N, A) in, obs (N, ...) / reward (N,) / done (N,) out.
    ``metrics_fn`` maps the post-rollout env state to extra scalar metrics
    merged into the iteration info.
    """

    rollout = make_step_rollout(apply_fn, env_step, config) if rollout_fn is None else rollout_fn

    def init(params: torch.nn.Module, env_state, obs0, generator: torch.Generator) -> PpoState:
        opt = torch.optim.Adam(params.parameters(), lr=config.learning_rate, eps=1e-5)
        return PpoState(params=params, opt_state=opt, env_state=env_state, last_obs=obs0,
                        generator=generator, update_count=0)

    def _loss(params, batch: Transition, advantages, targets):
        mean, log_std, value = apply_fn(params, batch.obs)
        log_prob = gaussian_log_prob(mean, log_std, batch.action)
        ratio = torch.exp(log_prob - batch.log_prob)
        adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1.0 - config.clip_eps, 1.0 + config.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(pg1, pg2))
        v_clipped = batch.value + torch.clamp(value - batch.value, -config.clip_eps,
                                              config.clip_eps)
        v_loss = 0.5 * torch.mean(torch.maximum((value - targets) ** 2,
                                                (v_clipped - targets) ** 2))
        ent = torch.mean(gaussian_entropy(log_std))
        total = pg_loss + config.vf_coef * v_loss - config.ent_coef * ent
        return total, {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent,
                       "approx_kl": torch.mean(batch.log_prob - log_prob)}

    def train_iteration(state: PpoState) -> Tuple[PpoState, Dict[str, torch.Tensor]]:
        net, opt, gen = state.params, state.opt_state, state.generator
        with torch.no_grad():
            env_state, last_obs, traj = rollout(state)
            _, _, last_value = apply_fn(net, last_obs)
            advantages, targets = compute_gae(traj.reward, traj.value, traj.done, last_value,
                                              config.gamma, config.gae_lambda)

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        batch = Transition(**{f.name: _tree_map(flat, getattr(traj, f.name))
                              for f in dataclasses.fields(Transition)})
        advantages, targets = flat(advantages), flat(targets)
        batch_size = config.num_steps * _leading(last_obs)
        mb_size = batch_size // config.num_minibatches
        block = max(1, config.shuffle_block)
        if batch_size % (block * config.num_minibatches) != 0:
            block = 1  # exact row shuffle for odd shapes
        n_blocks = batch_size // block
        device = advantages.device

        losses, metrics = [], {}
        for _ in range(config.update_epochs):
            perm = torch.randperm(n_blocks, generator=gen, device=gen.device).to(device)

            def shuffle(x):
                xb = x.reshape((n_blocks, block) + tuple(x.shape[1:]))
                return xb[perm].reshape((batch_size,) + tuple(x.shape[1:]))

            shuffled = Transition(**{f.name: _tree_map(shuffle, getattr(batch, f.name))
                                     for f in dataclasses.fields(Transition)})
            adv_sh, tgt_sh = shuffle(advantages), shuffle(targets)
            for idx in range(config.num_minibatches):
                sl = slice(idx * mb_size, (idx + 1) * mb_size)
                mb = Transition(**{f.name: _tree_map(lambda x: x[sl], getattr(shuffled, f.name))
                                   for f in dataclasses.fields(Transition)})
                loss, m = _loss(net, mb, adv_sh[sl], tgt_sh[sl])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_(net.parameters(), config.max_grad_norm)
                opt.step()
                losses.append(loss.detach())
                for k, v in m.items():
                    metrics.setdefault(k, []).append(v.detach())

        info = {"loss": torch.stack(losses).mean(),
                "mean_reward": traj.reward.mean(),
                "mean_episode_done": traj.done.to(torch.float32).mean(),
                **{k: torch.stack(v).mean() for k, v in metrics.items()}}
        if metrics_fn is not None:
            info.update(metrics_fn(env_state))
        new_state = state.replace(env_state=env_state, last_obs=last_obs,
                                  update_count=state.update_count + 1)
        return new_state, info

    return init, train_iteration


def scan_train(train_iteration, state: PpoState, num_iterations: int):
    """Run ``num_iterations`` train iterations; returns (state, infos) where
    each info value gains a leading (num_iterations,) axis. Nothing is read
    back to the host here."""
    infos = []
    for _ in range(num_iterations):
        state, info = train_iteration(state)
        infos.append(info)
    return state, {k: torch.stack([i[k] for i in infos]) for k in infos[0]}
