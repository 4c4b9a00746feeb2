"""The port's learner against the JAX package: ``PixelActorCritic`` and
``ActorCritic`` with carried weights, the Flax <-> state_dict interop,
``compute_gae``, one PPO update of ``make_ppo`` on a fixed trajectory for
either net, and the state trainers ``train_acro`` and ``train_race`` on the
CPU with checkpoint resume.

Tolerances:
- float32 pixel nets: 1e-6 absolute (the same float32 products, summed in
  another order by the two libraries' matrix products); ``ActorCritic``:
  1e-5 absolute (tanh layers of up to 128 units, float32);
- bf16 nets: 1e-3 of the output's largest magnitude. The layers round to
  bf16 after float32 sums taken in another order, so a hidden unit can land
  one bf16 step (2^-8 relative) away, which the float32 heads carry scaled
  by their weights (measured: 1e-9 on the mean, 1e-7 on the value);
- GAE: 1e-6 (the same recursion in float32);
- one PPO update in float32: loss terms and approx_kl 1e-6 absolute plus
  1e-5 relative, updated weights 1e-6 (Adam's first step moves each weight
  by about the learning rate whatever the gradient's size, so gradient
  rounding moves the weights by far less).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.models.policy import ActorCritic as JAC
from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.rl.gae import compute_gae as jgae
from fpyv_tpu.rl.ppo import PpoConfig as JConfig, Transition as JTransition, make_ppo as jmake
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps.train import train_acro, train_race
from fpyv_tpu_torch.models.policy import ActorCritic as TAC
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.rl.gae import compute_gae
from fpyv_tpu_torch.rl import ppo as tppo
from fpyv_tpu_torch.rl.ppo import PpoConfig, Transition, make_ppo
from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint

H, W, NP = 24, 32, 12
N = 16
OBS = 17  # AcroEnv's observation width (quaternion attitude)


def _nets(pool=1, prepatched=False, bf16=False, seed=0):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (None, None)
    jnet = JNet(action_dim=4, torso="patch", prepatched=prepatched, compute_dtype=jdt,
                patch_pool=pool)
    px = jnp.zeros((1, NP, 64) if prepatched else (1, H, W), jnp.float32)
    params = jnet.init(jax.random.key(seed), px, jnp.zeros((1, 5), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    tnet = TNet(action_dim=4, n_patches=NP, torso="patch", prepatched=prepatched,
                compute_dtype=tdt, patch_pool=pool, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    return jnet, params, tnet


def _inputs(seed, u8, prepatched, n=N):
    rng = np.random.default_rng(seed)
    lev = rng.integers(0, 256, size=(n, H, W)).astype(np.uint8)
    if prepatched:
        lev = lev.reshape(n, H // 8, 8, W // 8, 8).transpose(0, 1, 3, 2, 4).reshape(n, NP, 64)
    px = lev if u8 else (lev.astype(np.float32) / np.float32(255.0))
    proprio = rng.normal(size=(n, 5)).astype(np.float32)
    return px, proprio


@pytest.mark.parametrize("prepatched", [False, True])
@pytest.mark.parametrize("pool", [1, 4])
@pytest.mark.parametrize("u8", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_pixel_actor_critic_matches_flax(prepatched, pool, u8, bf16):
    jnet, params, tnet = _nets(pool, prepatched, bf16)
    px, proprio = _inputs(1, u8, prepatched)
    jm, jls, jv = jnet.apply(params, jnp.asarray(px), jnp.asarray(proprio))
    with torch.no_grad():
        tm, tls, tv = tnet(torch.from_numpy(px), torch.from_numpy(proprio))
    assert tm.dtype == tv.dtype == torch.float32
    if bf16:
        tol_m, tol_v = 1e-3 * np.abs(np.asarray(jm)).max(), 1e-3 * np.abs(np.asarray(jv)).max()
    else:
        tol_m = tol_v = 1e-6
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=tol_m, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=tol_v, rtol=0)
    np.testing.assert_array_equal(tls.detach().numpy(), np.asarray(jls))
    assert np.abs(np.asarray(jm)).max() > 1e-3  # premise: the heads are not all zero


def test_prepatched_matches_standard():
    """The patch-major path and the (H, W) path share parameters and give
    the same outputs (float32)."""
    _, params, std = _nets(prepatched=False)
    pre = TNet(action_dim=4, n_patches=NP, torso="patch", prepatched=True, compute_dtype=None,
               device="cpu")
    pre.load_state_dict(std.state_dict())
    px, proprio = _inputs(2, True, False)
    with torch.no_grad():
        a = std(torch.from_numpy(px), torch.from_numpy(proprio))
        b = pre(std.patchify(torch.from_numpy(px)), torch.from_numpy(proprio))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)


@pytest.mark.parametrize("pool", [1, 4])
def test_interop_round_trip(pool):
    _, params, tnet = _nets(pool)
    back = interop.policy_params_to_numpy(tnet)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    again = interop.policy_params_from_numpy(back, "cpu")
    for k, v in tnet.state_dict().items():
        torch.testing.assert_close(again[k], v, atol=0, rtol=0)


def test_init_follows_flax_distributions():
    net = TNet(action_dim=4, n_patches=108, torso="patch", device="cpu")
    net.init_params(torch.Generator().manual_seed(0))
    w = net.fc0.weight.detach()  # fan_in 13829
    std = 1.0 / np.sqrt(w.shape[1])
    assert abs(w.std().item() / std - 1.0) < 0.01
    assert w.abs().max().item() <= 2.0 * std / 0.87962566103423978 + 1e-6  # truncated at 2 sigma
    pm = net.pi_mean.weight.detach().double()  # (4, 256): orthonormal rows x 0.01
    torch.testing.assert_close(pm @ pm.T, 1e-4 * torch.eye(4, dtype=torch.float64), atol=1e-9,
                               rtol=0)
    assert torch.equal(net.log_std.detach(), torch.full((4,), -0.5))
    for layer in (net.patch_embed, net.fc0, net.pi_mean, net.v_out):
        assert not layer.bias.detach().any()


def _ac_nets(hidden=(128, 128), activation="tanh", shared=False, seed=0):
    jnet = JAC(action_dim=4, hidden=hidden, activation=activation, shared_torso=shared)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed),
                                                jnp.zeros((1, OBS), jnp.float32)))
    tnet = TAC(action_dim=4, obs_dim=OBS, hidden=hidden, activation=activation,
               shared_torso=shared, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    return jnet, params, tnet


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
@pytest.mark.parametrize("hidden", [(128, 128), (16, 16)])
def test_actor_critic_matches_flax(hidden, activation, shared):
    jnet, params, tnet = _ac_nets(hidden, activation, shared, seed=len(hidden) + hidden[0])
    obs = np.random.default_rng(hidden[0]).normal(size=(N, 3, OBS)).astype(np.float32)
    jm, jls, jv = jnet.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tm, tls, tv = tnet(torch.from_numpy(obs))
    assert tm.shape == (N, 3, 4) and tv.shape == (N, 3) and tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tls.detach().numpy(), np.asarray(jls))
    assert np.abs(np.asarray(jv)).max() > 1e-2  # premise: the value head is not all zero
    assert (set(params["params"]) - {"log_std"}
            == {n for n, _ in tnet.named_children()})  # Flax's layer names


@pytest.mark.parametrize("shared", [False, True])
def test_actor_critic_interop_round_trip(shared):
    _, params, tnet = _ac_nets(shared=shared)
    back = interop.policy_params_to_numpy(tnet)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    # a PPO state's checkpoint nests the tree once more
    again = interop.policy_params_from_numpy({"params": back}, "cpu")
    for k, v in tnet.state_dict().items():
        torch.testing.assert_close(again[k], v, atol=0, rtol=0)


def test_actor_critic_init_follows_flax():
    """Orthogonal kernels at Flax's scales (sqrt 2 in the torsos, 0.01 and 1
    for the heads), zero biases, log_std at its initial value: the Gram
    matrices of the port's and Flax's initial kernels are the same."""
    net = TAC(action_dim=4, obs_dim=OBS, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    _, jparams, _ = _ac_nets()
    jp = jparams["params"]
    for name, layer in net.named_children():
        k = layer.weight.detach().double().T  # Flax's (in, out) kernel
        scale = {"pi_mean": 0.01, "v_out": 1.0}.get(name, np.sqrt(2.0))
        small = min(k.shape)
        gram = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
        eye = scale**2 * torch.eye(small, dtype=torch.float64)
        torch.testing.assert_close(gram, eye, atol=1e-5 * scale**2, rtol=0)
        jk = jp[name]["kernel"].astype(np.float64)
        jgram = jk.T @ jk if jk.shape[0] >= jk.shape[1] else jk @ jk.T
        np.testing.assert_allclose(jgram, eye.numpy(), atol=1e-5 * scale**2, rtol=0)
        assert not layer.bias.detach().any()
    assert torch.equal(net.log_std.detach(), torch.full((4,), -0.5))
    assert not torch.equal(net.pi_dense0.weight, net.v_dense0.weight)  # premise: fresh draws


def test_bad_options_raise():
    """The conv torso, the GRU and Adam's bf16 moment are ported
    (tests/test_torch_conv_gru.py, tests/test_torch_recurrent.py); what
    neither package has raises."""
    with pytest.raises(ValueError, match="torso must be"):
        TNet(action_dim=4, n_patches=NP, torso="vit", device="cpu")
    with pytest.raises(ValueError, match="image_hw"):
        TNet(action_dim=4, n_patches=NP, torso="conv", device="cpu")
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        PpoConfig(adam_mu_dtype="fp8")


@pytest.mark.parametrize("seed", [0, 1])
def test_gae_matches_jax(seed):
    rng = np.random.default_rng(seed)
    T, n = 32, 64
    r = rng.normal(size=(T, n)).astype(np.float32)
    v = rng.normal(size=(T, n)).astype(np.float32)
    d = rng.random((T, n)) < 0.1
    last = rng.normal(size=(n,)).astype(np.float32)
    ja, jt = jgae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d), jnp.asarray(last), 0.99, 0.95)
    ta, tt = compute_gae(*map(torch.from_numpy, (r, v, d, last)), 0.99, 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# One PPO update on a fixed trajectory
# ---------------------------------------------------------------------------

T_PPO = 4
LOSS_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl")


def _ppo_setup(net, seed, reward_scale):
    """The net pair, both apply functions, and a fixed trajectory: obs
    (pixels and proprio, or the state vector) for T + 1 steps, actions
    sampled around the JAX net's mean, stored log-probs and values moved
    off the current net's, rewards and done flags."""
    rng = np.random.default_rng(seed)
    if net == "pixel":
        jnet, params, tnet = _nets(prepatched=True)
        px = rng.integers(0, 256, size=(T_PPO + 1, N, NP * 64)).astype(np.uint8)
        pr = rng.normal(size=(T_PPO + 1, N, 5)).astype(np.float32)
        obs = {"pixels": px, "proprio": pr}

        def j_apply(p, o):
            x = o["pixels"]
            return jnet.apply(p, x.reshape(x.shape[:-1] + (NP, 64)), o["proprio"])

        def t_apply(m, o):
            x = o["pixels"]
            return m(x.reshape(x.shape[:-1] + (NP, 64)), o["proprio"])
    else:
        jnet, params, tnet = _ac_nets(seed=1)
        obs = rng.normal(size=(T_PPO + 1, N, OBS)).astype(np.float32)

        def j_apply(p, o):
            return jnet.apply(p, o)

        def t_apply(m, o):
            return m(o)

    def part(sl, conv):
        return ({k: conv(v[sl]) for k, v in obs.items()} if isinstance(obs, dict)
                else conv(obs[sl]))

    jobs, jlast = part(slice(0, T_PPO), jnp.asarray), part(T_PPO, jnp.asarray)
    tobs, tlast = part(slice(0, T_PPO), torch.from_numpy), part(T_PPO, torch.from_numpy)
    mean, log_std, value = j_apply(params, jobs)
    mean, value = np.asarray(mean), np.asarray(value)
    action = (mean + np.exp(np.asarray(log_std)) * rng.normal(size=mean.shape)).astype(np.float32)
    # stored log-probs and values off the current net's, so the ratio and the
    # value clip have work to do
    lp = np.asarray(jnp.sum(-0.5 * ((action - mean) / np.exp(np.asarray(log_std)))**2
                            - np.asarray(log_std) - 0.5 * np.log(2 * np.pi), -1))
    lp = (lp + 0.05 * rng.normal(size=lp.shape)).astype(np.float32)
    value = (value + 0.3 * rng.normal(size=value.shape)).astype(np.float32)
    tr = dict(action=action, log_prob=lp, value=value,
              reward=(reward_scale * rng.normal(size=(T_PPO, N))).astype(np.float32),
              done=rng.random((T_PPO, N)) < 0.2)
    return jnet, params, tnet, j_apply, t_apply, (jobs, jlast), (tobs, tlast), tr


@pytest.mark.parametrize("case,max_grad_norm,reward_scale,net", [
    pytest.param("clip fires", 1e-3, 1.0, "pixel", id="clip fires-0.001-1.0"),
    pytest.param("no clip", 1e3, 10.0, "pixel", id="no clip-1000.0-10.0"),
    pytest.param("clip fires", 1e-3, 1.0, "state", id="state-clip fires-0.001-1.0"),
    pytest.param("no clip", 1e3, 10.0, "state", id="state-no clip-1000.0-10.0")])
def test_ppo_update_matches_jax(case, max_grad_norm, reward_scale, net, monkeypatch):
    """One update of the port's make_ppo against optax's on the same batch,
    for the pixel net and for ActorCritic."""
    jnet, params, tnet, j_apply, t_apply, (jobs, jlast), (tobs, tlast), tr = _ppo_setup(
        net, 3, reward_scale)
    kw = dict(num_envs=N, num_steps=T_PPO, update_epochs=1, num_minibatches=1,
              max_grad_norm=max_grad_norm)
    jtraj = JTransition(obs=jobs, action=jnp.asarray(tr["action"]),
                        log_prob=jnp.asarray(tr["log_prob"]), value=jnp.asarray(tr["value"]),
                        reward=jnp.asarray(tr["reward"]), done=jnp.asarray(tr["done"]))
    jinit, jiter = jmake(j_apply, None, JConfig(**kw),
                         rollout_fn=lambda s: (s.env_state, jlast, s.key, jtraj))
    jstate, jinfo = jiter(jinit(params, jnp.zeros(1), jlast, jax.random.key(0)))

    t = {k: torch.from_numpy(np.asarray(v)) for k, v in tr.items()}
    ttraj = Transition(obs=tobs, action=t["action"], log_prob=t["log_prob"], value=t["value"],
                       reward=t["reward"], done=t["done"])
    norms = []

    def clip_spy(ps, max_norm):
        norm = real_clip(ps, max_norm)
        norms.append(norm.item())
        return norm

    real_clip = tppo.clip_by_global_norm_
    monkeypatch.setattr(tppo, "clip_by_global_norm_", clip_spy)
    tinit, titer = make_ppo(t_apply, None, PpoConfig(**kw),
                            rollout_fn=lambda s: (s.env_state, tlast, ttraj))
    tstate, tinfo = titer(tinit(tnet, torch.zeros(1), tlast, torch.Generator().manual_seed(0)))

    for k in LOSS_KEYS:
        np.testing.assert_allclose(tinfo[k].item(), float(jinfo[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(tinfo["mean_reward"].item(), float(jinfo["mean_reward"]),
                               rtol=1e-6)
    new = jax.tree.leaves(interop.policy_params_to_numpy(tstate.params))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
    assert len(new) == len(ref)
    for a, b in zip(new, ref):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    moved = max(np.abs(b - p0).max() for b, p0 in zip(ref, jax.tree.leaves(params)))
    assert moved > 1e-4  # premise: the update moved the weights (lr 3e-4)
    # premise: the clip fires, or not, as the case says
    assert len(norms) == 1 and (norms[0] >= max_grad_norm) == (case == "clip fires")
    # premise: the advantage std matters: with torch's default Bessel-corrected
    # std the policy loss would differ from the JAX one by 10x its tolerance
    last_v = torch.from_numpy(np.array(j_apply(params, jlast)[2]))
    adv = compute_gae(t["reward"], t["value"], t["done"], last_v, 0.99, 0.95)[0].reshape(-1)
    m, ls, _ = j_apply(params, jtraj.obs)
    ratio = torch.from_numpy(np.array(jnp.exp(
        jnp.sum(-0.5 * ((jtraj.action - m) / jnp.exp(ls))**2 - ls - 0.5 * np.log(2 * np.pi), -1)
        - jtraj.log_prob))).reshape(-1)
    bessel = (adv - adv.mean()) / (adv.std() + 1e-8)
    pg_bessel = -torch.mean(torch.minimum(ratio * bessel, torch.clamp(ratio, 0.8, 1.2) * bessel))
    pg_tol = 1e-6 + 1e-5 * abs(float(jinfo["pg_loss"]))
    assert abs(pg_bessel.item() - float(jinfo["pg_loss"])) > 10 * pg_tol


def test_default_rollout_runs_a_toy_env():
    """make_ppo's own per-step rollout (no rollout_fn) on a point-mass env:
    shapes, a finite loss, and the generator drives the action noise."""

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mu = torch.nn.Linear(2, 1)
            self.v = torch.nn.Linear(2, 1)
            self.log_std = torch.nn.Parameter(torch.zeros(1))

        def forward(self, obs):
            return self.mu(obs), self.log_std, self.v(obs)[..., 0]

    def env_step(x, action, generator):
        x = x + 0.1 * torch.cat([action, -action], -1)
        reward = -(x * x).sum(-1)
        done = reward < -4.0
        x = torch.where(done[:, None], torch.zeros_like(x), x)
        return x, x, reward, done

    def run(seed):
        cfg = PpoConfig(num_envs=32, num_steps=8, update_epochs=2, num_minibatches=4,
                        shuffle_block=8)
        init, it = make_ppo(lambda net, obs: net(obs), env_step, cfg)
        torch.manual_seed(0)
        net = Lin()
        x0 = torch.zeros(32, 2)
        state = init(net, x0, x0, torch.Generator().manual_seed(seed))
        for _ in range(3):
            state, info = it(state)
        return state, info

    s1, info = run(0)
    s2, _ = run(0)
    s3, _ = run(1)
    assert s1.update_count == 3 and s1.env_state.shape == (32, 2)
    assert all(np.isfinite(v.item()) for v in info.values())
    assert torch.equal(s1.env_state, s2.env_state)  # same generator seed, same run
    assert not torch.equal(s1.env_state, s3.env_state)


def test_metrics_and_throughput(tmp_path):
    """The port's own copies of the JAX utils: the JSONL logger, the
    env-steps/s meter and the mean +- std timer."""
    import json

    from fpyv_tpu_torch.utils.metrics import MetricsLogger
    from fpyv_tpu_torch.utils.profiling import Throughput, timeit

    log = MetricsLogger(str(tmp_path), print_every=0)
    log.log(3, {"loss": np.float32(0.5), "vec": np.arange(4.0)})
    log.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["vec"] == 1.5
    meter = Throughput()
    meter.add(1000)
    assert meter.rate() > 0 and meter.report().endswith("env-steps/s")
    meter.reset()
    assert meter.rate() == 0.0
    out, (mean, std) = timeit(lambda x: x + 1, n=3)(1)
    assert out == 2 and mean >= 0 and std >= 0


# ---------------------------------------------------------------------------
# The state trainers on the CPU
# ---------------------------------------------------------------------------

TRAINERS = {"acro": train_acro, "race": train_race}


def _train_state(tmp_path, kind, name, iterations, resume=False, log=False):
    kw = dict(n_agents=2, max_episode_steps=6) if kind == "race" else {}
    return TRAINERS[kind](num_envs=8, num_iterations=iterations, num_steps=4, seed=5,
                          scan_chunk=1, hidden=(16, 16), checkpoint_dir=str(tmp_path / name),
                          checkpoint_every=2, resume=resume,
                          log_dir=str(tmp_path / "log") if log else None, print_every=0,
                          device="cpu", **kw)


@pytest.mark.parametrize("kind", ["acro", "race"])
def test_state_trainer_cpu_smoke(kind, tmp_path):
    import json

    res = _train_state(tmp_path, kind, "ck", 2, log=True)
    assert res.iterations == 2
    assert np.isfinite(res.mean_reward_first) and np.isfinite(res.mean_reward_last)
    rows = [json.loads(ln) for ln in (tmp_path / "log" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["approx_kl"]) for r in rows)
    if kind == "race":
        assert all(np.isfinite(r["mean_gates_passed"]) and np.isfinite(r["gates_per_100_steps"])
                   for r in rows)


@pytest.mark.parametrize("kind", ["acro", "race"])
def test_state_trainer_resume_matches_unbroken_run(kind, tmp_path):
    """4 iterations in one run against 2 + a resume for 2 more: the step-4
    checkpoints (params, Adam, the env bank, last obs, generator) are equal."""
    _train_state(tmp_path, kind, "whole", 4)
    _train_state(tmp_path, kind, "split", 2)
    _train_state(tmp_path, kind, "split", 2, resume=True)
    a = restore_checkpoint(str(tmp_path / "whole"), 4)
    b = restore_checkpoint(str(tmp_path / "split"), 4)
    assert a["update_count"] == b["update_count"] == 4
    flat_a, flat_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(flat_a) == len(flat_b) > 10
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y
    c = restore_checkpoint(str(tmp_path / "split"), 2)
    assert not torch.equal(c["last_obs"], b["last_obs"])  # premise: the envs moved


@pytest.mark.parametrize("kind", ["acro", "race"])
def test_state_trainer_distributed_at_world_size_1(kind):
    """``distributed=True`` with no process group trains on the one-rank
    mesh (bit-equal to one process: tests/test_torch_dist_trainers.py)."""
    kw = dict(n_agents=2) if kind == "race" else {}
    res = TRAINERS[kind](num_envs=8, num_iterations=1, num_steps=4, hidden=(16, 16),
                         print_every=0, distributed=True, device="cpu", **kw)
    assert res.iterations == 1 and np.isfinite(res.mean_reward_last)
