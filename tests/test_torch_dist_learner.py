"""The port's multi-process learner against the JAX package's sharded one,
and the layout independence of its rollouts, at world size 2 over gloo on
the CPU (``fpyv_tpu_torch.parallel.launch``; the ranks' side is
``tests/torch_dist_ranks.py``).

- One ``make_distributed_ppo`` iteration of ``ActorCritic`` on fixed
  trajectories, each rank its half, against JAX's ``make_ppo`` with
  ``axis_name="env"`` under ``shard_map`` over two of the 8 virtual CPU
  devices, each shard the same half through ``rollout_fn`` and the info
  ``pmean``ed as ``fpyv_tpu/parallel/train.py`` does it; with a clip that
  fires and one that does not.
- One ``make_recurrent_ppo`` iteration with ``axis_name`` on
  ``tests/test_torch_recurrent.py``'s toy env against JAX's recurrent
  learner under ``shard_map``, each shard's threefry draws (its action noise
  and permutations) fed through the port's seams.
- Fixed-action rollouts of ``AcroEnv`` (auto-resets on the way) and of the
  shared-policy race are bit-equal at world sizes 1 and 2
  (``tests/test_parallel.py``'s two layout tests); the first PPO rollout of
  ``train_acro``'s trainer with its net agrees within 1e-6.

Tolerances: the updated parameters 1e-6, the info 1e-6 + 1e-5 relative,
the final hidden and toy state 1e-6, as the single-process parity tests of
the same learners (``tests/test_torch_policy.py``,
``tests/test_torch_recurrent.py``); the two ranks' parameters are equal bit
for bit. Each launch has a 120 s deadline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as ranks
from fpyv_tpu.models.policy import ActorCritic as JAC
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.parallel.mesh import make_mesh as jmake_mesh
from fpyv_tpu.rl.ppo import PpoConfig as JConfig
from fpyv_tpu.rl.ppo import PpoState as JState
from fpyv_tpu.rl.ppo import Transition as JTransition
from fpyv_tpu.rl.ppo import make_ppo as jmake
from fpyv_tpu.rl.ppo import make_recurrent_ppo as jmake_recurrent
from fpyv_tpu_torch.parallel.launch import launch

W = 2
DEADLINE = 120.0
LOSS_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl")
N, T = 16, 4


def _sharded(jiter, mesh):
    """JAX's per-shard iteration under shard_map, the info pmean'd
    (``fpyv_tpu/parallel/train.py:55-70``)."""
    spec = JState(params=P(), opt_state=P(), env_state=P("env"), last_obs=P("env"),
                  key=P("env"), update_count=P())

    def local(state):
        state, info = jiter(state.replace(key=state.key[0]))
        return state.replace(key=state.key[None]), jax.lax.pmean(info, "env")

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=(spec, P()),
                             check_vma=False))


def _assert_info(tinfo, jinfo):
    for k in LOSS_KEYS + ("mean_reward", "mean_episode_done"):
        np.testing.assert_allclose(tinfo[k], float(jinfo[k]), atol=1e-6, rtol=1e-5, err_msg=k)


def _assert_params(outs, jparams, p0):
    """Both ranks' parameters bit-equal, within 1e-6 of JAX's, and moved."""
    a, b = (jax.tree.leaves(o) for o in outs)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(a) == len(ref)
    for x, y in zip(a, ref):
        np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
    assert max(np.abs(y - z).max() for y, z in zip(ref, jax.tree.leaves(p0))) > 1e-4


def _ff_setup(seed, reward_scale):
    """ActorCritic's weights and a fixed trajectory over N envs: obs for
    T + 1 steps, actions around the net's mean, stored log-probs and values
    moved off the net's, rewards and done flags."""
    rng = np.random.default_rng(seed)
    jnet = JAC(action_dim=4, hidden=ranks.HIDDEN)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed),
                                                jnp.zeros((1, ranks.OBS), jnp.float32)))
    obs = rng.normal(size=(T + 1, N, ranks.OBS)).astype(np.float32)
    mean, log_std, value = (np.asarray(x) for x in jnet.apply(params, obs[:T]))
    action = (mean + np.exp(log_std) * rng.normal(size=mean.shape)).astype(np.float32)
    lp = np.sum(-0.5 * ((action - mean) / np.exp(log_std))**2 - log_std
                - 0.5 * np.log(2 * np.pi), -1)
    traj = dict(obs=obs[:T], action=action,
                log_prob=(lp + 0.05 * rng.normal(size=lp.shape)).astype(np.float32),
                value=(value + 0.3 * rng.normal(size=value.shape)).astype(np.float32),
                reward=(reward_scale * rng.normal(size=(T, N))).astype(np.float32),
                done=rng.random((T, N)) < 0.2)
    return jnet, params, traj, obs[T]


@pytest.mark.parametrize("case,max_grad_norm,reward_scale", [
    ("clip fires", 1e-3, 1.0), ("no clip", 1e3, 10.0)])
def test_distributed_update_matches_jax_shard_map(case, max_grad_norm, reward_scale):
    """make_distributed_ppo over two ranks against JAX's make_ppo with
    axis_name under shard_map: each half's gradients averaged before the
    clip, the info averaged after."""
    jnet, params, traj, last = _ff_setup(3, reward_scale)
    kw = dict(num_envs=N, num_steps=T, update_epochs=1, num_minibatches=1,
              max_grad_norm=max_grad_norm)

    def rollout_fn(s):  # each shard's half rides its env state, (N/W, T, ...)
        tr = {k: jnp.swapaxes(v, 0, 1) for k, v in s.env_state.items()}
        return s.env_state, s.last_obs, s.key, JTransition(**tr)

    jinit, jiter = jmake(jnet.apply, None, JConfig(**dict(kw, num_envs=N // W), axis_name="env"),
                         rollout_fn=rollout_fn)
    env_state = {k: jnp.asarray(np.swapaxes(v, 0, 1)) for k, v in traj.items()}
    jstate = jinit(params, env_state, jnp.asarray(last), jax.random.split(jax.random.key(0), W))
    jstate, jinfo = _sharded(jiter, jmake_mesh(W))(jstate)

    outs = launch(ranks.ppo_update, W, (params, traj, last, kw), deadline=DEADLINE)
    for _, tinfo, _ in outs:
        _assert_info(tinfo, jinfo)
    _assert_params([o[0] for o in outs], jstate.params, params)
    # premise: one global norm, the same on both ranks, and the clip fires
    # or not as the case says
    (na,), (nb,) = (o[2] for o in outs)
    assert na == nb and (na >= max_grad_norm) == (case == "clip fires")


def _jax_stream(key, n, n_blocks, epochs):
    """JAX's recurrent draws inside one shard's train_iteration, reproduced
    outside its scan (``tests/test_torch_recurrent.py``)."""
    noises = []
    for _ in range(ranks.T_R):
        key, ka, _ = jax.random.split(key, 3)
        noises.append(np.asarray(jax.random.normal(ka, (n, 4), jnp.float32)))
    perms = []
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kp, n_blocks)))
    return noises, perms


def test_distributed_recurrent_update_matches_jax_shard_map():
    """make_recurrent_ppo with axis_name over two ranks, 8 envs each in two
    minibatches over two epochs (envs reset mid-rollout), against JAX's
    recurrent learner under shard_map."""
    n, kw = 16, dict(update_epochs=2, num_minibatches=2, shuffle_block=2)
    jnet = JNet(action_dim=4, torso="patch", gru=ranks.GRU, compute_dtype=None)
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.key(1), jnp.zeros((1,) + ranks.HW, jnp.float32),
        jnp.zeros((1, 2), jnp.float32), jnp.zeros((1, ranks.GRU), jnp.float32)))
    x0 = np.random.default_rng(2).normal(scale=0.4, size=(n, 2)).astype(np.float32)
    obs_fn, step = ranks.toy(jnp)
    jinit, jiter = jmake_recurrent(
        lambda p, obs, h: jnet.apply(p, obs["pixels"], obs["proprio"], h),
        lambda x, a, key: step(x, a),
        JConfig(num_envs=n // W, num_steps=ranks.T_R, axis_name="env", **kw))
    keys = jax.random.split(jax.random.key(3), W)
    jx = jnp.asarray(x0)
    jstate = jinit(params, jx, obs_fn(jx), jnp.zeros((n, ranks.GRU), jnp.float32), keys)
    jstate, jinfo = _sharded(jiter, jmake_mesh(W))(jstate)

    n_local = n // W
    mb_envs = n_local // kw["num_minibatches"]
    block = max(1, min(kw["shuffle_block"], mb_envs))
    streams = [_jax_stream(k, n_local, n_local // block, kw["update_epochs"]) for k in keys]
    noises = [np.concatenate([s[0][t] for s in streams]) for t in range(ranks.T_R)]
    perms = [s[1] for s in streams]
    outs = launch(ranks.recurrent_update, W, (params, x0, noises, perms, kw),
                  deadline=DEADLINE)
    for _, _, tinfo in outs:
        _assert_info(tinfo, jinfo)
    _assert_params([o[0] for o in outs], jstate.params, params)
    tx = np.concatenate([o[1][0] for o in outs])
    th = np.concatenate([o[1][1] for o in outs])
    jx_end, jh = jstate.env_state
    np.testing.assert_allclose(tx, np.asarray(jx_end), atol=1e-6, rtol=0)
    np.testing.assert_allclose(th, np.asarray(jh), atol=1e-6, rtol=0)
    # premises: envs reset inside the rollout; the shards drew apart
    assert 0.0 < float(jinfo["mean_episode_done"]) < 0.5
    assert not np.array_equal(streams[0][0][0], streams[1][0][0])


def _joined(outs, axis):
    return [np.concatenate([o[i] for o in outs], axis=axis) for i in range(len(outs[0]))]


def test_acro_rollout_is_layout_independent():
    """64 fixed-action steps of a 16-env AcroEnv bank whose episodes last 10
    steps: rewards, positions and done flags bit-equal at world sizes 1 and
    2 (the reset draws are made for the whole bank and sliced)."""
    one = ranks.acro_layout(None, 16, 64, 10)
    two = _joined(launch(ranks.acro_layout, W, (16, 64, 10), deadline=DEADLINE), axis=1)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    assert one[2].sum() >= 16 * 5  # premise: every env reset on the way


def test_race_rollout_is_layout_independent():
    """20 fixed-action steps of 8 two-agent races (episodes of 8 steps):
    rewards, positions and gate counters bit-equal at world sizes 1 and 2,
    whole races a rank."""
    one = ranks.race_layout(None, 8, 2, 20)
    outs = launch(ranks.race_layout, W, (8, 2, 20), deadline=DEADLINE)
    two = _joined(outs, axis=1)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    assert outs[0][2].shape[1] == 4  # premise: 4 whole races a rank


def test_first_ppo_rollout_is_layout_independent():
    """train_acro's trainer over two ranks: its first rollout with the net
    (the action noise drawn for the whole bank and sliced) agrees with one
    process within 1e-6."""
    one = ranks.first_rollout(None, 16)
    outs = launch(ranks.first_rollout, W, (16,), deadline=DEADLINE)
    for i, a in enumerate(one):
        b = np.concatenate([o[i] for o in outs], axis=0 if i == 6 else 1)
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=1e-6,
                                   rtol=0)
