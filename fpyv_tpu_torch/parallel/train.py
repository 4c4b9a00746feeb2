"""Distributed PPO: one rank per GPU, each stepping its slice of the env
bank (mirrors ``fpyv_tpu.parallel.train``).

Layout, as JAX's ``shard_map`` lays it out:

- the env carry and the last observation: this rank's contiguous rows of
  the bank; the rollout needs no communication;
- the parameters: equal on every rank (a broadcast from rank 0), and Adam
  equal because it starts fresh and sees the same averaged gradients;
- the learner: ``make_ppo`` on ``num_envs // W`` envs with ``axis_name``
  set, whose ``_update`` averages each minibatch's gradients over the ranks
  (one all-reduce) before the global-norm clip, as JAX ``pmean``s before
  optax's clip;
- the info dict: averaged over the ranks, as JAX ``pmean``s it.

Where JAX's rollouts are the same for any layout because the per-env keys
ride in the env state, the port keeps one ``torch.Generator``, the same on
every rank: every draw shaped like the bank (the action noise, the resets)
is made at the whole bank's shape and sliced (``envs.base.Part``), and the
learner's epoch shuffle is drawn at the local shape, the same on every rank.
So the generators stay in lockstep, and W ranks replay one rank's rollout.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Callable, Optional

from fpyv_tpu_torch.parallel.mesh import Mesh, pmean_tree, replicate, shard_leading_axis
from fpyv_tpu_torch.rl.ppo import PpoConfig, PpoState, make_ppo, make_step_rollout


def local_config(config: PpoConfig, mesh: Mesh) -> PpoConfig:
    """The per-rank config: ``num_envs // W`` envs, ``axis_name`` the
    mesh's axis."""
    if config.num_envs % mesh.size:
        raise ValueError(f"num_envs={config.num_envs} does not split evenly over "
                         f"{mesh.size} ranks")
    return dc_replace(config, num_envs=config.num_envs // mesh.size, axis_name=mesh.axis)


def make_distributed_ppo(
    apply_fn: Callable,
    env_step: Optional[Callable],
    config: PpoConfig,
    mesh: Mesh,
    metrics_fn: Optional[Callable] = None,
    rollout_fn: Optional[Callable] = None,
):
    """Returns (init, train_iteration) of one rank.

    ``config.num_envs`` is the GLOBAL env count; each rank runs
    ``num_envs // mesh.size``. ``env_step`` steps this rank's slice and
    draws its resets for it (the envs' ``part=mesh.part(num_envs)``); the
    default rollout draws the action noise at the global shape and slices
    it. ``rollout_fn`` replaces that rollout, built on
    :func:`local_config`'s config. ``metrics_fn`` runs on the local env
    state; its scalars are averaged with the rest of the info, so counters
    must be rank-local means. ``init`` takes the whole bank's state; pass
    its result through :func:`shard_ppo_state`."""
    cfg = local_config(config, mesh)
    if rollout_fn is None:
        rollout_fn = make_step_rollout(apply_fn, env_step, cfg, part=mesh.part(config.num_envs))
    init, local_iteration = make_ppo(apply_fn, None, cfg, metrics_fn=metrics_fn,
                                     rollout_fn=rollout_fn)

    def train_iteration(state: PpoState):
        state, info = local_iteration(state)
        return state, pmean_tree(info, mesh)

    return init, train_iteration


def shard_ppo_state(state: PpoState, mesh: Mesh) -> PpoState:
    """A state built over the whole bank, laid out for training: this rank's
    rows of the env carry and the last observation, rank 0's parameters.
    Adam must be fresh (as ``init`` makes it), so it is equal on every rank;
    the generator must hold the same seed on every rank."""
    replicate(state.params, mesh)
    return state.replace(env_state=shard_leading_axis(state.env_state, mesh),
                         last_obs=shard_leading_axis(state.last_obs, mesh))
