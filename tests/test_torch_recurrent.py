"""The port's bf16-moment Adam against optax's ``adam(mu_dtype=bfloat16)``,
and its recurrent PPO (``make_recurrent_ppo``) against the JAX package's on
a toy env that is deterministic given the action, in both frameworks.

JAX draws its action noise and its per-epoch permutations from threefry
keys inside its scan, where the port has no seam. So the test reproduces
JAX's stream outside the scan (``key, ka, ks = split(key, 3)`` and
``normal(ka, mean.shape)`` a step, ``key, kp = split(key)`` and
``permutation(kp, n_blocks)`` an epoch, ``fpyv_tpu/rl/ppo.py:289-291``,
``:368-369``) and feeds it into the port through ``rl.ppo.action_noise``
and ``rl.ppo.permutation``, which the test monkeypatches.

Tolerances:
- Adam with a bf16 first moment, three updates: the stored moments equal
  bit for bit, the parameters within 2e-7 (one float32 ulp at the weights'
  size; measured: equal);
- one recurrent PPO iteration in float32: loss terms and approx_kl 1e-6
  absolute plus 1e-5 relative, updated weights 1e-6 (as the feedforward
  update of tests/test_torch_policy.py: Adam moves each weight by about the
  learning rate, so gradient rounding moves them by far less), the rollout's
  final hidden and env state 1e-6. The learner runs the float32 Adam here:
  with the bf16 moment a gradient rounding can flip a moment's bf16
  rounding, a whole bf16 step, so that optimizer is held bit for bit on
  equal gradients above instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fpyv_tpu.models.policy import PixelActorCritic as JNet
from fpyv_tpu.rl.ppo import PpoConfig as JConfig
from fpyv_tpu.rl.ppo import make_recurrent_ppo as jmake_recurrent
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.models.policy import PixelActorCritic as TNet
from fpyv_tpu_torch.rl import ppo as tppo
from fpyv_tpu_torch.rl.ppo import AdamBf16Mu, PpoConfig, make_recurrent_ppo

LOSS_KEYS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl")


# ---------------------------------------------------------------------------
# Adam with a bf16 first moment
# ---------------------------------------------------------------------------


def test_bf16_moment_adam_matches_optax():
    """Three updates of a conv + GRU net's parameters with gradients spread
    over five decades: the port's moments equal optax's (mu bf16, nu
    float32), the parameters within one ulp; a float32 moment (what
    ``torch.optim.Adam`` keeps) lands measurably elsewhere."""
    net = TNet(action_dim=4, torso="conv", image_hw=(17, 33), gru=16, compute_dtype=None,
               device="cpu").init_params(torch.Generator().manual_seed(0))
    tree = interop.policy_params_to_numpy(net)
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: (rng.normal(size=p.shape)
                                     * 10.0 ** rng.uniform(-4, 1, size=p.shape)).astype(np.float32),
                          tree) for _ in range(3)]
    tx = optax.adam(3e-4, eps=1e-5, mu_dtype=jnp.bfloat16)
    jp = jax.tree.map(jnp.asarray, tree)
    jst = tx.init(jp)
    opt = AdamBf16Mu(net.parameters(), lr=3e-4, eps=1e-5)
    f32_net = TNet(action_dim=4, torso="conv", image_hw=(17, 33), gru=16, compute_dtype=None,
                   device="cpu")
    f32_net.load_state_dict(net.state_dict())
    f32_opt = torch.optim.Adam(f32_net.parameters(), lr=3e-4, eps=1e-5)
    for g in grads:
        updates, jst = tx.update(jax.tree.map(jnp.asarray, g), jst, jp)
        jp = optax.apply_updates(jp, updates)
        sd = interop.policy_params_from_numpy(g, "cpu")
        for m in (net, f32_net):
            for name, p in m.named_parameters():
                p.grad = sd[name].clone()
        opt.step()
        f32_opt.step()
    ref = interop.policy_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    mu = interop.policy_params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), jst[0].mu), "cpu")
    nu = interop.policy_params_from_numpy(jax.tree.map(np.asarray, jst[0].nu), "cpu")
    assert jst[0].mu["params"]["fc0"]["kernel"].dtype == jnp.bfloat16
    f32_gap = 0.0
    for (name, p), (_, q) in zip(net.named_parameters(), f32_net.named_parameters()):
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
        assert st["step"] == 3
        assert torch.equal(st["exp_avg"].float(), mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        torch.testing.assert_close(p.detach(), ref[name], atol=2e-7, rtol=0)
        f32_gap = max(f32_gap, (q.detach() - ref[name]).abs().max().item())
    assert f32_gap > 1e-6  # premise: the bf16 moment changes the weights


def test_bf16_moment_adam_state_round_trips(tmp_path):
    """The checkpoint holds the moments as the optimizer keeps them, and a
    restore gives them back in those dtypes (torch.optim casts floating
    state to the parameters' dtype on load)."""
    from fpyv_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    p = torch.nn.Parameter(torch.ones(5))
    opt = AdamBf16Mu([p], lr=1e-3, eps=1e-5)
    p.grad = torch.linspace(-1, 1, 5)
    opt.step()
    save_checkpoint(tmp_path, 1, {"opt": opt})
    raw = restore_checkpoint(tmp_path, 1)
    assert raw["opt"]["state"][0]["exp_avg"].dtype == torch.bfloat16
    q = torch.nn.Parameter(torch.ones(5))
    back = restore_checkpoint(tmp_path, 1, template={"opt": AdamBf16Mu([q], lr=1e-3, eps=1e-5)})
    st = back["opt"].state[q]
    assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
    assert torch.equal(st["exp_avg"], opt.state[p]["exp_avg"]) and st["step"] == 1


# ---------------------------------------------------------------------------
# Recurrent PPO on a toy env
# ---------------------------------------------------------------------------

T_R = 6
GRU = 8
HW = (8, 16)  # two 8x8 patches
_grid = np.random.default_rng(7).normal(size=(2,) + HW).astype(np.float32)


def _toy(xp):
    """The toy env in either framework (``xp`` = jnp or torch): a point
    pushed by the first two action components; reward -|x|^2; done where
    |x|^2 > 0.5, which resets x to 0. Obs: pixels linear in x, and x."""
    grid = xp.asarray(_grid) if xp is jnp else torch.from_numpy(_grid)

    def obs(x):
        return {"pixels": x[:, 0, None, None] * grid[0] + x[:, 1, None, None] * grid[1],
                "proprio": x}

    def step(x, action):
        x = x + 0.25 * action[:, :2]
        reward = -xp.sum(x * x, -1)
        done = reward < -0.5
        x = xp.where(done[:, None], xp.zeros_like(x), x)
        return x, obs(x), reward, done

    return obs, step


def _jax_stream(key, n, n_blocks, epochs):
    """JAX's draws inside train_iteration, reproduced outside its scan: the
    action noise of each step, then each epoch's permutation."""
    noises = []
    for _ in range(T_R):
        key, ka, _ = jax.random.split(key, 3)
        noises.append(np.asarray(jax.random.normal(ka, (n, 4), jnp.float32)))
    perms = []
    for _ in range(epochs):
        key, kp = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(kp, n_blocks)))
    return noises, perms


CASES = {
    "one-minibatch": dict(n=8, update_epochs=1, num_minibatches=1, shuffle_block=64),
    "two-minibatches": dict(n=8, update_epochs=2, num_minibatches=2, shuffle_block=2),
    "envs-dropped": dict(n=10, update_epochs=1, num_minibatches=3, shuffle_block=64),
}


def _run_port(case, params, x0, noises, perms, monkeypatch):
    kw = dict(CASES[case])
    n = kw.pop("n")
    tnet = TNet(action_dim=4, n_patches=2, proprio_dim=2, torso="patch", gru=GRU,
                compute_dtype=None, device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    obs_fn, step = _toy(torch)
    noise_q = [torch.from_numpy(np.array(v)) for v in noises]
    perm_q = [torch.from_numpy(p.astype(np.int64)) for p in perms]
    monkeypatch.setattr(tppo, "action_noise", lambda mean, gen: noise_q.pop(0))
    monkeypatch.setattr(tppo, "permutation", lambda m, gen, device: perm_q.pop(0))
    init, iteration = make_recurrent_ppo(
        lambda net, obs, h: net(obs["pixels"], obs["proprio"], h),
        lambda x, a, gen: step(x, a), PpoConfig(num_envs=n, num_steps=T_R, **kw))
    x = torch.from_numpy(x0)
    state = init(tnet, x, obs_fn(x), torch.zeros((n, GRU)), torch.Generator().manual_seed(0))
    state, info = iteration(state)
    assert not noise_q and not perm_q  # every draw consumed, none more
    return state, info


@pytest.mark.parametrize("case", list(CASES))
def test_recurrent_ppo_matches_jax(case, monkeypatch):
    """One iteration of make_recurrent_ppo, the port's against JAX's: T = 6
    steps of a GRU-8 patch net over n envs (several reset mid-rollout, so
    the hidden is zeroed inside the rollout and inside the re-scan), GAE,
    then the sequence-minibatched learner. The loss terms, approx_kl, the
    updated weights, the final hidden and env state agree."""
    kw = dict(CASES[case])
    n = kw.pop("n")
    jnet = JNet(action_dim=4, torso="patch", gru=GRU, compute_dtype=None)
    params = jax.tree.map(np.asarray, jnet.init(
        jax.random.key(1), jnp.zeros((1,) + HW, jnp.float32), jnp.zeros((1, 2), jnp.float32),
        jnp.zeros((1, GRU), jnp.float32)))
    x0 = np.random.default_rng(2).normal(scale=0.4, size=(n, 2)).astype(np.float32)
    obs_fn, step = _toy(jnp)
    jinit, jiter = jmake_recurrent(
        lambda p, obs, h: jnet.apply(p, obs["pixels"], obs["proprio"], h),
        lambda x, a, key: step(x, a), JConfig(num_envs=n, num_steps=T_R, **kw))
    key = jax.random.key(3)
    jx = jnp.asarray(x0)
    jstate, jinfo = jiter(jinit(params, jx, obs_fn(jx), jnp.zeros((n, GRU), jnp.float32), key))

    mb_envs = n // kw["num_minibatches"]
    block = max(1, min(kw["shuffle_block"], mb_envs))
    if n % block or mb_envs % block:
        block = 1
    noises, perms = _jax_stream(key, n, n // block, kw["update_epochs"])
    tstate, tinfo = _run_port(case, params, x0, noises, perms, monkeypatch)

    for k in LOSS_KEYS:
        np.testing.assert_allclose(tinfo[k].item(), float(jinfo[k]), atol=1e-6, rtol=1e-5,
                                   err_msg=k)
    new = interop.policy_params_to_numpy(tstate.params)
    ref = jax.tree.map(np.asarray, jstate.params)
    assert jax.tree.structure(new) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(new), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    (tx, th), (jx_end, jh) = tstate.env_state, jstate.env_state
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx_end), atol=1e-6, rtol=0)
    # premises: the update moved the weights; envs reset inside the rollout
    # (their hidden zeroed) and the final hidden is not all zero
    moved = max(np.abs(b - p0).max() for b, p0 in zip(jax.tree.leaves(ref),
                                                       jax.tree.leaves(params)))
    assert moved > 1e-4
    assert 0.0 < float(jinfo["mean_episode_done"]) < 0.5
    assert np.abs(np.asarray(jh)).max() > 1e-2
    if case == "two-minibatches":
        assert all(not np.array_equal(p, np.arange(len(p))) for p in perms)
    if case == "envs-dropped":
        # 10 envs in 3 minibatches of 3: the env the permutation puts last
        # drops out; dropping another one instead moves the weights
        assert n % kw["num_minibatches"] == 1 and block == 1
        other = perms[0].copy()
        other[[0, -1]] = other[[-1, 0]]
        alt, _ = _run_port(case, params, x0, noises, [other], monkeypatch)
        gap = max(np.abs(a - b).max() for a, b in zip(
            jax.tree.leaves(interop.policy_params_to_numpy(alt.params)), jax.tree.leaves(ref)))
        assert gap > 1e-5
