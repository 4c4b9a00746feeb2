"""Generalized Advantage Estimation (mirrors ``fpyv_tpu.rl.gae``).

The JAX version is a reverse ``lax.scan`` of plain array math, no kernel;
here it is a reversed loop over T.
"""

from __future__ import annotations

import torch


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                last_value: torch.Tensor, gamma: float, lam: float):
    """GAE(gamma, lambda) over a trajectory batch.

    rewards, values, dones: (T, N), ``dones`` the episode end AFTER each
    transition; last_value: (N,) the bootstrap value of the state after step
    T-1. Returns (advantages (T, N), value targets (T, N)).
    """
    advantages = torch.empty_like(values)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(rewards.shape[0])):
        nonterminal = 1.0 - dones[t].to(values.dtype)
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        advantages[t] = gae
        next_value = values[t]
    return advantages, advantages + values
