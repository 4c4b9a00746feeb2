"""The port's SAC against the JAX package: the ring replay, the actor and
the twin critic against Flax, their interop, the squashed sample, three
SAC updates and the warm-up and sampled train steps with JAX's draws fed
through the port's seams, the reach task learning on the CPU and
``train_sac`` on the CPU.

Tolerances:
- the nets: 1e-6 of the output's largest magnitude, at least 1e-6 (the
  same float32 products, summed in another order by the two libraries'
  matrix products; inputs of scale 30, so that both log_std clips fire);
- the squashed sample from the same mean, log_std and noise: action 1e-6
  absolute, log-prob 1e-6 absolute plus 1e-6 relative (XLA's and
  PyTorch's exp, log1p and tanh differ by an ulp on equal inputs: 1.2e-6
  measured on log-probs near -6);
- the updates: losses, alpha and entropy 1e-6 absolute plus 1e-5 relative;
  every parameter of the actor, critic and target critic, and log_alpha,
  within 1e-6 after each of three updates (Adam moves a weight by about the
  learning rate whatever the gradient's size, so the gradients' rounding
  moves the weights by far less: the largest gap measured was 6e-8);
- the replay's contents: equal after a warm-up step (uniform actions);
  1e-6 after a sampled step (its actions are the actor's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.models.policy import SquashedGaussianActor as JActor
from fpyv_tpu.models.policy import TwinQNetwork as JCritic
from fpyv_tpu.rl.replay import replay_add_batch as j_add
from fpyv_tpu.rl.replay import replay_init as j_init
from fpyv_tpu.rl.sac import SacConfig as JConfig
from fpyv_tpu.rl.sac import _squashed_sample as j_squashed
from fpyv_tpu.rl.sac import make_sac as j_make_sac
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps.train import train_sac
from fpyv_tpu_torch.models.policy import SquashedGaussianActor, TwinQNetwork
from fpyv_tpu_torch.rl import replay as treplay
from fpyv_tpu_torch.rl import sac as tsac
from fpyv_tpu_torch.rl.replay import replay_add_batch, replay_init, replay_sample
from fpyv_tpu_torch.rl.sac import SacConfig, make_sac

OBS, ACT = 17, 4


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------


class TestReplay:
    def test_ring_semantics(self):
        buf = replay_init(8, 2, 1, device="cpu")
        for i in range(3):
            obs = torch.full((4, 2), float(i))
            buf = replay_add_batch(buf, obs, torch.zeros(4, 1), torch.zeros(4), obs,
                                   torch.zeros(4))
        assert buf.size == 8  # capacity reached
        assert buf.ptr == 4  # wrapped
        # newest batch (i=2) overwrote slots 0..3
        np.testing.assert_allclose(buf.obs[0].numpy(), [2.0, 2.0])
        np.testing.assert_allclose(buf.obs[4].numpy(), [1.0, 1.0])

    def test_sample_within_valid(self):
        buf = replay_init(100, 2, 1, device="cpu")
        obs = torch.arange(10.0).reshape(5, 2)
        buf = replay_add_batch(buf, obs, torch.zeros(5, 1), torch.ones(5), obs, torch.zeros(5))
        o, a, r, no, d = replay_sample(buf, torch.Generator().manual_seed(0), 64)
        assert o.shape == (64, 2)
        np.testing.assert_allclose(r.numpy(), 1.0)  # only valid entries

    @pytest.mark.parametrize("cap,sizes", [(10, (4, 4, 4, 4)), (8, (3, 11, 2)), (6, (6, 6))])
    def test_contents_equal_jax_after_a_wrap(self, cap, sizes):
        """Batches that wrap the ring (and one larger than it): every field,
        ptr and size equal to JAX's buffer; float64 and bool inputs cast."""
        rng = np.random.default_rng(cap)
        jbuf, tbuf = j_init(cap, 3, 2), replay_init(cap, 3, 2, device="cpu")
        for n in sizes:
            obs, nxt = rng.normal(size=(2, n, 3))  # float64: cast to the buffer's float32
            act = rng.normal(size=(n, 2)).astype(np.float32)
            rew = rng.normal(size=n).astype(np.float32)
            done = rng.random(n) < 0.5
            if n > cap:  # JAX scatters duplicate slots: give them equal rows
                obs, nxt, act, rew, done = (np.concatenate([x[n - cap:]] * 2)[-n:]
                                            for x in (obs, nxt, act, rew, done))
            jbuf = j_add(jbuf, *map(jnp.asarray, (obs, act, rew, nxt, done)))
            tbuf = replay_add_batch(tbuf, *map(torch.from_numpy, (obs, act, rew, nxt, done)))
        for name in ("obs", "action", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(getattr(tbuf, name).numpy(),
                                          np.asarray(getattr(jbuf, name)), err_msg=name)
            assert getattr(tbuf, name).dtype == torch.float32
        assert (tbuf.ptr, tbuf.size) == (int(jbuf.ptr), int(jbuf.size))


# ---------------------------------------------------------------------------
# The nets
# ---------------------------------------------------------------------------


def _sac_nets(hidden=(128, 128), seed=0):
    jactor, jcritic = JActor(action_dim=ACT, hidden=hidden), JCritic(hidden=hidden)
    obs = jnp.zeros((1, OBS), jnp.float32)
    ka, kc = jax.random.split(jax.random.key(seed))
    ap = jax.tree.map(np.asarray, jactor.init(ka, obs))
    cp = jax.tree.map(np.asarray, jcritic.init(kc, obs, jnp.zeros((1, ACT), jnp.float32)))
    tactor = SquashedGaussianActor(action_dim=ACT, obs_dim=OBS, hidden=hidden, device="cpu")
    tcritic = TwinQNetwork(obs_dim=OBS, action_dim=ACT, hidden=hidden, device="cpu")
    asd, csd = interop.sac_params_from_numpy({"actor": ap, "critic": cp}, "cpu")
    tactor.load_state_dict(asd)
    tcritic.load_state_dict(csd)
    return (jactor, ap, tactor), (jcritic, cp, tcritic)


@pytest.mark.parametrize("hidden", [(128, 128), (16,)])
def test_nets_match_flax(hidden):
    """Both nets against Flax on the same weights; the actor's log_std is a
    Dense layer clipped to [-10, 2] (inputs scaled so both clips fire)."""
    (jactor, ap, tactor), (jcritic, cp, tcritic) = _sac_nets(hidden, seed=len(hidden))
    rng = np.random.default_rng(1)
    obs = (30.0 * rng.normal(size=(8, 3, OBS))).astype(np.float32)
    act = rng.uniform(-1, 1, size=(8, 3, ACT)).astype(np.float32)
    jm, jls = jactor.apply(ap, jnp.asarray(obs))
    jq1, jq2 = jcritic.apply(cp, jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        tm, tls = tactor(torch.from_numpy(obs))
        tq1, tq2 = tcritic(torch.from_numpy(obs), torch.from_numpy(act))
    assert tm.shape == tls.shape == (8, 3, ACT) and tq1.shape == tq2.shape == (8, 3)
    for a, b in ((tm, jm), (tls, jls), (tq1, jq1), (tq2, jq2)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6 * max(1.0, np.abs(
            np.asarray(b)).max()), rtol=0)
    jls = np.asarray(jls)
    assert (jls == 2.0).any() and (jls == -10.0).any()  # premise: both clips fire
    assert set(ap["params"]) == {n for n, _ in tactor.named_children()}  # Flax's names
    assert set(cp["params"]) == {n for n, _ in tcritic.named_children()}


def test_init_follows_flax():
    """lecun_normal kernels (std sqrt(1/fan_in), truncated at 2 sigma) and
    zero biases, as Flax's default Dense."""
    actor = SquashedGaussianActor(ACT, OBS, hidden=(256, 256), device="cpu").init_params(
        torch.Generator().manual_seed(0))
    critic = TwinQNetwork(OBS, ACT, hidden=(256, 256), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    (_, ap, _), (_, cp, _) = _sac_nets((256, 256))
    for net, tree in ((actor, ap), (critic, cp)):
        for name, layer in net.named_children():
            w = layer.weight.detach().double()
            std = 1.0 / np.sqrt(w.shape[1])
            jk = tree["params"][name]["kernel"].astype(np.float64)
            assert jk.shape == tuple(w.T.shape)
            for x in (w.numpy(), jk):
                if x.size >= 4096:
                    assert abs(x.std() / std - 1.0) < 0.05, name
                assert np.abs(x).max() <= 2.0 * std / 0.87962566103423978 + 1e-6, name
            assert not layer.bias.detach().any()
    assert not torch.equal(critic.q1_dense1.weight, critic.q2_dense1.weight)  # fresh draws


def test_interop_round_trip():
    """Both trees out and back; the actor's Dense log_std is a layer (a dict
    with a kernel), ActorCritic's a bare array, through one converter."""
    (_, ap, tactor), (_, cp, tcritic) = _sac_nets()
    assert set(ap["params"]["log_std"]) == {"kernel", "bias"}
    back = interop.sac_params_to_numpy(tactor, tcritic)
    for ours, ref in ((back["actor"], ap), (back["critic"], cp)):
        assert jax.tree.structure(ours) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    asd, csd = interop.sac_params_from_numpy(back, "cpu")
    for net, sd in ((tactor, asd), (tcritic, csd)):
        assert set(sd) == set(net.state_dict())
        for k, v in net.state_dict().items():
            torch.testing.assert_close(sd[k], v, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# The squashed sample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_squashed_sample_matches_jax(scale, monkeypatch):
    """a = tanh(u) and its log-prob from the same mean, log_std and noise
    (the Flax actor's, on inputs of the given scale; the nets' own parity is
    test_nets_match_flax). At scale 40 the pre-squash u reaches |u| > 10,
    past torch softplus's threshold of 20 on -2u, where JAX's logaddexp
    form keeps its log1p term."""
    (jactor, ap, _), _ = _sac_nets(seed=3)
    rng = np.random.default_rng(2)
    obs = (scale * rng.normal(size=(256, OBS))).astype(np.float32)
    noise = rng.normal(size=(256, ACT)).astype(np.float32)
    jm, jls = jactor.apply(ap, jnp.asarray(obs))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype: jnp.asarray(noise))
    ja, jlp = j_squashed(lambda p, o: (jm, jls), None, None, None)
    monkeypatch.undo()
    mean, log_std = torch.from_numpy(np.array(jm)), torch.from_numpy(np.array(jls))
    ta, tlp = tsac._squashed_sample(lambda o: (mean, log_std), None, torch.from_numpy(noise))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6, rtol=1e-6)
    u = (mean + torch.exp(log_std) * torch.from_numpy(noise)).numpy()
    if scale > 1.0:
        assert (np.abs(u) > 10).any()  # premise: past the softplus threshold
        x = torch.from_numpy(-2.0 * u)  # where torch's own softplus differs
        assert not torch.equal(torch.nn.functional.softplus(x), tsac._softplus(x))


# ---------------------------------------------------------------------------
# Updates and train steps with JAX's draws fed through the seams
# ---------------------------------------------------------------------------

N_ENVS, BATCH = 16, 32


# a deterministic toy env, each output at most one rounding of a product and
# one of a sum (XLA may contract a product into a sum), so both libraries
# compute it alike
def _toy_env_jax(five):
    def env_step(st, action, key):
        reward = action[:, 0] * st[:, 0]
        nxt = 0.5 * st + 0.3 * jnp.tile(action, (1, 5))[:, :OBS]
        done = (reward < -0.2).astype(jnp.float32)
        out = (nxt, nxt, reward, done)
        return out + (2.0 * nxt,) if five else out
    return env_step


def _toy_env_torch(five):
    def env_step(st, action, generator):
        reward = action[:, 0] * st[:, 0]
        nxt = 0.5 * st + 0.3 * torch.tile(action, (1, 5))[:, :OBS]
        done = reward < -0.2
        out = (nxt, nxt, reward, done)
        return out + (2.0 * nxt,) if five else out
    return env_step


def _jax_draws(key, size_after, updates, random_actions):
    """JAX's train_step draws, in its key order: the action's (uniform
    warm-up or the squashed sample's normal), then per update ks, ka, kn
    (the sample's indices, the actor's noise, the next action's noise)."""
    key, kact, _kenv, kupd = jax.random.split(key, 4)
    if random_actions:
        act = jax.random.uniform(kact, (N_ENVS, ACT), jnp.float32, minval=-1.0, maxval=1.0)
    else:
        act = jax.random.normal(kact, (N_ENVS, ACT), jnp.float32)
    ups = []
    for _ in range(updates):
        kupd, ki = jax.random.split(kupd)
        ks, ka, kn = jax.random.split(ki, 3)
        idx = jax.random.randint(ks, (BATCH,), 0, jnp.maximum(jnp.int32(size_after), 1))
        ups.append((np.asarray(idx), np.asarray(jax.random.normal(kn, (BATCH, ACT), jnp.float32)),
                    np.asarray(jax.random.normal(ka, (BATCH, ACT), jnp.float32))))
    return key, np.asarray(act), ups


class _Seams:
    """The port's three draw seams replaced by queues of JAX's draws, in
    the port's call order."""

    def __init__(self, monkeypatch):
        self.uniform, self.normal, self.indices = [], [], []
        monkeypatch.setattr(tsac, "uniform_actions", lambda *a: self._pop(self.uniform))
        monkeypatch.setattr(tsac, "squash_noise", lambda *a: self._pop(self.normal))
        monkeypatch.setattr(treplay, "replay_indices", lambda *a: self._pop(self.indices))

    @staticmethod
    def _pop(q):
        return torch.from_numpy(np.array(q.pop(0)))

    def feed(self, act, ups, random_actions):
        (self.uniform if random_actions else self.normal).append(act)
        for idx, n_next, n_actor in ups:
            self.indices.append(idx.astype(np.int64))
            self.normal.extend([n_next, n_actor])

    def empty(self):
        return not (self.uniform or self.normal or self.indices)


def _compare_state(tstate, jstate, buffer_atol, atol=1e-6):
    for tnet, jtree in ((tstate.actor, jstate.actor_params),
                        (tstate.critic, jstate.critic_params),
                        (tstate.target_critic, jstate.target_critic_params)):
        ours = jax.tree.leaves(interop.policy_params_to_numpy(tnet))
        ref = jax.tree.leaves(jax.tree.map(np.asarray, jtree))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            np.testing.assert_allclose(a, b, atol=atol, rtol=0)
    np.testing.assert_allclose(tstate.log_alpha.item(), float(jstate.log_alpha), atol=atol,
                               rtol=0)
    for name in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_allclose(getattr(tstate.buffer, name).numpy(),
                                   np.asarray(getattr(jstate.buffer, name)), atol=buffer_atol,
                                   rtol=0, err_msg=name)
    assert (tstate.buffer.ptr, tstate.buffer.size) == (int(jstate.buffer.ptr),
                                                      int(jstate.buffer.size))


def _run_both(monkeypatch, steps, updates, five, hidden=(64, 64)):
    """The port's and JAX's SAC from the same nets, obs and prefilled
    replay, ``steps`` train steps each ((random_actions, ...) per step);
    yields both states and metrics after every step (the port's modules
    change in place: compare before the next step)."""
    (jactor, ap, tactor), (jcritic, cp, tcritic) = _sac_nets(hidden, seed=5)
    rng = np.random.default_rng(4)
    obs0 = rng.normal(size=(N_ENVS, OBS)).astype(np.float32)
    cap = 96
    pre = dict(obs=rng.normal(size=(40, OBS)), action=rng.uniform(-1, 1, size=(40, ACT)),
               reward=rng.normal(size=40), next_obs=rng.normal(size=(40, OBS)),
               done=rng.random(40) < 0.3)
    pre = {k: v.astype(np.float32) for k, v in pre.items()}
    order = ("obs", "action", "reward", "next_obs", "done")

    jcfg = JConfig(num_envs=N_ENVS, buffer_capacity=cap, batch_size=BATCH,
                   updates_per_step=updates)
    jinit, jstep = j_make_sac(jactor.apply, jcritic.apply, _toy_env_jax(five), jcfg, OBS, ACT)
    jstep = jax.jit(jstep, static_argnames="random_actions")
    jstate = jinit(ap, cp, jnp.asarray(obs0), jnp.asarray(obs0), jax.random.key(7))
    jstate = jstate.replace(buffer=j_add(jstate.buffer, *(jnp.asarray(pre[k]) for k in order)))

    tcfg = SacConfig(num_envs=N_ENVS, buffer_capacity=cap, batch_size=BATCH,
                     updates_per_step=updates)
    tinit, tstep = make_sac(_toy_env_torch(five), tcfg, OBS, ACT)
    tstate = tinit(tactor, tcritic, torch.from_numpy(obs0), torch.from_numpy(obs0),
                   torch.Generator().manual_seed(0))
    tstate = tstate.replace(buffer=replay_add_batch(
        tstate.buffer, *(torch.from_numpy(pre[k]) for k in order)))

    seams = _Seams(monkeypatch)
    for random_actions in steps:
        key, act, ups = _jax_draws(jstate.key, min(int(jstate.buffer.size) + N_ENVS, cap),
                                   updates, random_actions)
        jstate, jm = jstep(jstate, random_actions=random_actions)
        assert np.array_equal(jax.random.key_data(jstate.key), jax.random.key_data(key))
        seams.feed(act, ups, random_actions)
        tstate, tm = tstep(tstate, random_actions=random_actions)
        assert seams.empty()  # every draw of the port went through a seam
        yield tstate, jstate, tm, jm


def _compare_metrics(tm, jm):
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=1e-6, rtol=1e-5, err_msg=k)


def test_three_updates_match_jax(monkeypatch):
    """Three train steps with sampled actions, one update each: the losses,
    alpha and entropy of each update, and the actor, critic, target critic
    and log_alpha after each, against JAX's make_sac on its own draws."""
    for tstate, jstate, tm, jm in _run_both(monkeypatch, (False, False, False), 1, five=False):
        _compare_metrics(tm, jm)
        _compare_state(tstate, jstate, buffer_atol=1e-6)
    moved = max(np.abs(a).max() for a in jax.tree.leaves(
        interop.policy_params_to_numpy(tstate.actor)["params"]["mean"]["bias"]))
    assert moved > 5e-4  # premise: three Adam steps at 3e-4 moved the actor
    assert abs(tstate.log_alpha.item()) > 5e-4  # and the temperature


def test_train_steps_warmup_and_sampled_with_store_obs(monkeypatch):
    """A warm-up step (uniform actions) and a sampled step, two updates
    each, on the 5-tuple env: the replay stores the 5th element as the
    successor; buffer, metrics and nets equal to JAX's."""
    for i, (tstate, jstate, tm, jm) in enumerate(
            _run_both(monkeypatch, (True, False), 2, five=True)):
        _compare_metrics(tm, jm)
        # the warm-up's transitions equal; the sampled step's actions (and
        # the toy env's successors of them) are the actor's, within 1e-6
        _compare_state(tstate, jstate, buffer_atol=0.0 if i == 0 else 1e-6)
    np.testing.assert_array_equal(tstate.buffer.next_obs[40:56].numpy(),
                                  (2.0 * tstate.buffer.obs[56:72]).numpy())


def test_critic_takes_no_gradient_from_the_actor_loss(monkeypatch):
    """After an update the critic's .grad is the critic loss's alone: the
    actor loss ran through the frozen critic."""
    (_, _, tactor), (_, _, tcritic) = _sac_nets((16, 16), seed=1)
    cfg = SacConfig(num_envs=N_ENVS, buffer_capacity=64, batch_size=BATCH)
    seen = []
    real_step = tsac._step

    def spy(opt, loss):
        real_step(opt, loss)
        seen.append({id(p): None if p.grad is None else p.grad.clone()
                     for p in tcritic.parameters()})

    monkeypatch.setattr(tsac, "_step", spy)
    init, step = make_sac(_toy_env_torch(False), cfg, OBS, ACT)
    obs0 = torch.randn(N_ENVS, OBS, generator=torch.Generator().manual_seed(0))
    state = init(tactor, tcritic, obs0, obs0, torch.Generator().manual_seed(1))
    step(state)
    critic_grads, after_actor = seen[0], seen[1]
    for pid, g in after_actor.items():
        assert torch.equal(g, critic_grads[pid])  # unchanged by the actor's backward
    assert all(p.requires_grad for p in tcritic.parameters())  # unfrozen again


# ---------------------------------------------------------------------------
# Learning and the trainer
# ---------------------------------------------------------------------------


def test_reach_task():
    """tests/test_sac.py's reach task: echo the observation; the reward
    rises by more than 0.05 over 250 learning steps."""
    N, obs_dim, act_dim = 64, 3, 3
    torch.manual_seed(0)
    actor = SquashedGaussianActor(act_dim, obs_dim, hidden=(64, 64), device="cpu").init_params(
        torch.Generator().manual_seed(1))
    critic = TwinQNetwork(obs_dim, act_dim, hidden=(64, 64), device="cpu").init_params(
        torch.Generator().manual_seed(2))
    config = SacConfig(num_envs=N, buffer_capacity=20_000, batch_size=128, updates_per_step=1)

    def env_step(target, action, generator):
        reward = -torch.sum((action - target) ** 2, dim=-1)
        new_target = -0.5 + torch.rand(target.shape, generator=generator)
        return new_target, new_target, reward, torch.ones(N)

    g = torch.Generator().manual_seed(3)
    obs0 = -0.5 + torch.rand((N, obs_dim), generator=g)
    init, train_step = make_sac(env_step, config, obs_dim, act_dim)
    state = init(actor, critic, obs0, obs0, g)
    for _ in range(20):
        state, m = train_step(state, random_actions=True)
    rewards = []
    for _ in range(250):
        state, m = train_step(state)
        rewards.append(m["mean_reward"].item())
    early, late = np.mean(rewards[:25]), np.mean(rewards[-25:])
    assert late > early + 0.05, (early, late)
    assert np.isfinite(m["alpha"].item())


def test_train_sac_on_the_cpu(tmp_path):
    """A small train_sac: every iteration logged with finite losses, the
    replay filled by warm-up and learning steps."""
    import json

    res = train_sac(num_envs=8, num_iterations=4, warmup_steps=2, buffer_capacity=64,
                    batch_size=16, updates_per_step=2, hidden=(16, 16), scan_chunk=2,
                    log_dir=str(tmp_path), print_every=0, device="cpu")
    assert res.iterations == 4 and np.isfinite(res.mean_reward_first)
    assert np.isfinite(res.mean_reward_last) and res.steps_per_second > 0
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 4
    for row in rows:
        assert {"critic_loss", "actor_loss", "alpha", "entropy", "mean_reward"} <= set(row)
        assert all(np.isfinite(row[k]) for k in ("critic_loss", "actor_loss", "alpha"))


def test_train_sac_logs_the_rows_jax_logs(tmp_path):
    """With ``print_every > 0`` the metrics log keeps the iterations the JAX
    trainer logs, ``it % print_every == 0`` (fpyv_tpu/apps/train.py:458-459):
    steps 0 and 2 of 4 at ``print_every=2``."""
    import json

    train_sac(num_envs=8, num_iterations=4, warmup_steps=2, buffer_capacity=64,
              batch_size=16, updates_per_step=2, hidden=(16, 16), scan_chunk=3,
              log_dir=str(tmp_path), print_every=2, device="cpu")
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 2]
