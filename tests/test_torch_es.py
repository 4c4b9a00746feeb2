"""The port's gradient-free learners against the JAX package: ``RotateEnv``
(reset and step from the same state, with and without the gyro noise, JAX's
draws fed through the port's seams), theta's layout against
``ravel_pytree``, the centered ranks with ties, five NES generations and
the Monte-Carlo search with JAX's noise fed in, the ES trainer's batched
candidate forward, its common random numbers across resets, and
``train_es`` on the CPU.

Tolerances:
- ``RotateEnv``: 1e-6 absolute on the matrices, the observation and the
  reward (elementwise float32 products; XLA may contract a product and a
  sum into one rounding); done flags equal;
- theta: equal (the same leaves in the same order);
- NES: theta, sigma and the best-fitness history within 1e-6 after each of
  five generations (theta's step sums P products in another order);
- Monte-Carlo search: the incumbent and its score within 1e-6;
- the batched forward: 1e-5 absolute, as ``ActorCritic``'s own test (tanh
  layers of 64 units, float32; 1.4e-6 measured on means near 3).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from fpyv_tpu.envs.rotate import RotateEnv as JRotate
from fpyv_tpu.models.policy import ActorCritic as JAC
from fpyv_tpu.rl.es import make_policy_es as j_make_es
from fpyv_tpu.rl.es import monte_carlo_search as j_mcs
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.apps import train as ttrain
from fpyv_tpu_torch.apps.train import make_es_trainer, train_es
from fpyv_tpu_torch.envs import rotate as trotate
from fpyv_tpu_torch.envs.acro import AcroEnv
from fpyv_tpu_torch.envs.rotate import RotateEnv, RotateState
from fpyv_tpu_torch.models.policy import ActorCritic, actor_mean_batched
from fpyv_tpu_torch.rl import es as tes
from fpyv_tpu_torch.rl.es import centered_ranks, make_policy_es, monte_carlo_search

N = 64


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# RotateEnv
# ---------------------------------------------------------------------------


def _jax_reset_draws(sub):
    """JAX's _sample(sub) draws for one env: the goal's Euler angles and
    the offset's normal."""
    kg, kc = jax.random.split(sub)
    return (jax.random.uniform(kg, (3,), jnp.float32, minval=0.0, maxval=2.0 * jnp.pi),
            jax.random.normal(kc, (3,), jnp.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rotate_reset_matches_jax(monkeypatch):
    """Reset from JAX's draws: goal, current (the offset taken mod 2π) and
    the (3, 3, 2) observation, goal first."""
    keys = jax.random.split(jax.random.key(0), N)
    jenv = JRotate(dtype=jnp.float32)
    jst, jobs = jax.vmap(jenv.reset)(keys)
    subs = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    u, n = jax.vmap(_jax_reset_draws)(subs)
    monkeypatch.setattr(trotate, "reset_draws", lambda *a: (_t(u), _t(n)))
    st, obs = RotateEnv().reset(torch.Generator(), (N,), "cpu")
    assert obs.shape == (N, 3, 3, 2) and not st.done.any()
    np.testing.assert_allclose(st.goal.numpy(), np.asarray(jst.goal), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st.current.numpy(), np.asarray(jst.current), atol=1e-6, rtol=0)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=1e-6, rtol=0)
    assert (np.asarray(u + n) < 0).any() or (np.asarray(u + n) > 2 * np.pi).any()  # mod fires


@pytest.mark.parametrize("noise,threshold", [(0.0, 1e-3), (5.0, 1e-3), (5.0, 2.0)])
def test_rotate_step_matches_jax(noise, threshold, monkeypatch):
    """One step from the same state with JAX's gyro noise and reset draws
    fed in: the envs that reach the goal (the first 8 start there with no
    action, or the threshold is loose) restart from JAX's draws."""
    keys = jax.random.split(jax.random.key(1), N)
    jenv = JRotate(dtype=jnp.float32, noise_lvl_deg=noise, threshold=threshold)
    jst, _ = jax.vmap(jenv.reset)(keys)
    jst = jst.replace(current=jst.current.at[:8].set(jst.goal[:8]))
    action = np.random.default_rng(0).uniform(-0.3, 0.3, size=(N, 3)).astype(np.float32)
    action[:8] = 0.0
    jnext, jobs, jr, jd, jinfo = jax.vmap(jenv.step)(jst, jnp.asarray(action))

    def draws(k):  # step's key order: the gyro noise, then the reset
        if noise > 0:
            k, kn = jax.random.split(k)
            gyro = jax.random.normal(kn, (3,), jnp.float32)
        else:
            gyro = jnp.zeros(3, jnp.float32)
        _, sub = jax.random.split(k)
        return (gyro,) + _jax_reset_draws(sub)

    gyro, u, n = jax.vmap(draws)(jst.key)
    monkeypatch.setattr(trotate, "gyro_noise", lambda *a: _t(gyro))
    monkeypatch.setattr(trotate, "reset_draws", lambda *a: (_t(u), _t(n)))
    tst = RotateState(goal=_t(jst.goal), current=_t(jst.current), done=_t(jst.done))
    env = RotateEnv(noise_lvl_deg=noise, threshold=threshold)
    nxt, obs, r, d, info = env.step(tst, torch.from_numpy(action), torch.Generator())
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(nxt.done.numpy(), np.asarray(jnext.done))
    for a, b in ((nxt.goal, jnext.goal), (nxt.current, jnext.current), (obs, jobs),
                 (r, jr), (info["error"], jinfo["error"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    jd = np.asarray(jd)
    if noise == 0.0 or threshold > 1e-3:
        assert jd.any() and not jd.all()  # premise: some envs reset, some go on
    if noise == 0.0:
        assert jd[:8].all()


def test_rotate_shared_resets_broadcast():
    """``reset_shape`` draws (N,) resets for a (B, N) bank: env i of every
    candidate restarts in the same state."""
    env = RotateEnv(threshold=10.0)  # every env reaches the goal
    st, _ = env.reset(torch.Generator().manual_seed(0), (3, 5), "cpu")
    nxt, _, _, d, _ = env.step(st, torch.zeros(3, 5, 3), torch.Generator().manual_seed(1),
                               reset_shape=(5,))
    assert d.all()
    for x in (nxt.goal, nxt.current):
        assert torch.equal(x[0], x[1]) and torch.equal(x[0], x[2])
        assert not torch.equal(x[0, 0], x[0, 1])


# ---------------------------------------------------------------------------
# theta and the ranks
# ---------------------------------------------------------------------------


def _ac_tree(action_dim=4, obs_dim=17, hidden=(64, 64), seed=0):
    jnet = JAC(action_dim=action_dim, hidden=hidden)
    params = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed),
                                                jnp.zeros((1, obs_dim), jnp.float32)))
    return jnet, params


def test_ravel_matches_ravel_pytree():
    """The port's theta of an ActorCritic tree (from the port's own net,
    through interop) is JAX's ravel_pytree vector: same length and order;
    unravel gives the leaves back, batched along leading dims."""
    jnet, params = _ac_tree()
    tnet = ActorCritic(action_dim=4, obs_dim=17, hidden=(64, 64), device="cpu")
    tnet.load_state_dict(interop.policy_params_from_numpy(params, "cpu"))
    theta = interop.ravel_params(interop.policy_params_to_numpy(tnet))
    jtheta, junravel = ravel_pytree(params)
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    batch = torch.stack([theta, 2.0 * theta])
    tree = interop.unravel_params(batch, params)
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(params):
        ours = functools.reduce(lambda node, k: node[k.key], path, tree)
        assert ours.shape == (2,) + leaf.shape
        np.testing.assert_array_equal(ours[1].numpy(), 2.0 * leaf)
    ours = list(interop.policy_params_to_numpy(tnet)["params"])
    assert ours != sorted(ours)  # premise: the state_dict's order is not theta's
    with pytest.raises(ValueError, match="entries"):
        interop.unravel_params(theta[:-1], params)


def _jax_centered_ranks(x):
    ranks = jnp.argsort(jnp.argsort(x)).astype(jnp.float32)
    return ranks / (x.shape[0] - 1) - 0.5


@pytest.mark.parametrize("case", ["ties", "distinct", "all_equal"])
def test_centered_ranks_match_jax(case):
    rng = np.random.default_rng(3)
    x = {"ties": rng.integers(0, 4, size=32).astype(np.float32),
         "distinct": rng.normal(size=32).astype(np.float32),
         "all_equal": np.zeros(8, np.float32)}[case]
    ours = centered_ranks(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(_jax_centered_ranks(jnp.asarray(x))))
    assert ours.min() == -0.5 and ours.max() == 0.5


# ---------------------------------------------------------------------------
# NES and the Monte-Carlo search with JAX's draws
# ---------------------------------------------------------------------------


def _fitnesses(kind):
    """A fitness of one parameter in both frameworks, exact in float32:
    smooth (a square) or with ties (a floor)."""
    if kind == "smooth":
        return (lambda p, k: -(p["w"][0] - 1.0) ** 2,
                lambda p, g, c: -(p["w"][:, 0] - 1.0) ** 2)
    return (lambda p, k: -jnp.floor(4.0 * jnp.abs(p["w"][0] - 1.0)),
            lambda p, g, c: -torch.floor(4.0 * torch.abs(p["w"][:, 0] - 1.0)))


@pytest.mark.parametrize("kind", ["smooth", "ties"])
def test_policy_es_five_generations_match_jax(kind, monkeypatch):
    """Five generations of make_policy_es with JAX's eps: theta, sigma
    (decaying on the generations that do not improve) and the best-fitness
    history after each."""
    params = {"w": np.zeros(5, np.float32), "b": np.zeros(2, np.float32)}
    P, dim = 6, 7
    jfit, tfit = _fitnesses(kind)
    kw = dict(n_perturbations=P, noise_std=0.3, learning_rate=0.2, sigma_decay=0.7)
    jinit, jrun, _ = j_make_es(jax.tree.map(jnp.asarray, params), jfit, **kw)
    tinit, trun, tunravel = make_policy_es(params, tfit, device="cpu", **kw)
    keys = jax.random.split(jax.random.key(4), 5)
    eps = [np.asarray(jax.random.normal(jax.random.split(k)[0], (P, dim), jnp.float32))
           for k in keys]
    queue = list(eps)
    monkeypatch.setattr(tes, "es_noise", lambda *a: torch.from_numpy(np.array(queue.pop(0))))
    jstate, tstate = jinit(), tinit()
    decayed = 0
    for i in range(5):
        jstate, jhist = jax.jit(jrun)(jstate, keys[i:i + 1])
        sigma = tstate[1].item()
        tstate, thist = trun(tstate, 1, torch.Generator())
        decayed += tstate[1].item() < sigma
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
        np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), atol=1e-6, rtol=0)
    assert not queue and 0 < decayed < 5  # premise: sigma decayed on some generations
    assert np.abs(tunravel(tstate[0])["w"].numpy()).max() > 0.1  # premise: theta moved


def test_policy_es_takes_a_mesh():
    """A one-rank mesh (no process group) gives the generations of no mesh
    bit for bit; the two-rank split is held in tests/test_torch_dist_trainers.py."""
    from fpyv_tpu_torch.parallel.mesh import make_mesh

    def fitness(p, generator, common):
        w = p["w"]
        return -((w - 0.5) ** 2).sum(-1) + 0.01 * torch.rand(w.shape[0], generator=generator)

    out = []
    for mesh in (None, make_mesh(device="cpu")):
        init, run, _ = make_policy_es({"w": np.zeros(3, np.float32)}, fitness,
                                      n_perturbations=4, mesh=mesh, device="cpu")
        out.append(run(init(), 3, torch.Generator().manual_seed(0)))
    (sa, ha), (sb, hb) = out
    assert all(torch.equal(a, b) for a, b in zip(sa, sb)) and torch.equal(ha, hb)
    assert sa[0].abs().max() > 0  # premise: theta moved


@pytest.mark.parametrize("entry", ["make_policy_es", "policy_es"])
def test_policy_es_runs_on_cuda_unless_told(entry):
    """With no device, theta lives on CUDA wherever the tree's leaves are
    (a numpy tree here); where there is no card the call raises and never
    falls back to the CPU."""
    from fpyv_tpu_torch.rl.es import policy_es

    params = {"w": np.zeros(2, np.float32)}

    def fitness(p, g, c):
        return -torch.sum(p["w"] ** 2, -1)

    def call():
        if entry == "make_policy_es":
            return make_policy_es(params, fitness)[0]()[0]
        return policy_es(torch.Generator(), params, fitness, n_perturbations=2,
                         n_iterations=1)[0]["w"]

    if torch.cuda.is_available():
        assert call().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_monte_carlo_search_matches_jax(monkeypatch):
    """Ten generations with JAX's offspring noise: the incumbent and its
    score; the run moves the incumbent, recombines and keeps elites."""
    c = np.asarray([1.0, -2.0, 0.5], np.float32)
    x0 = np.zeros(3, np.float32)
    kw = dict(n_offspring=8, n_iterations=10, noise_std=0.3, temperature=0.1)
    jx, js = j_mcs(jax.random.key(5), jnp.asarray(x0),
                   lambda x: -jnp.sum((x - jnp.asarray(c)) ** 2), **kw)
    noise = [np.asarray(jax.random.normal(k, (8, 3), jnp.float32))
             for k in jax.random.split(jax.random.key(5), 10)]
    monkeypatch.setattr(tes, "offspring_noise", lambda *a: torch.from_numpy(np.array(noise.pop(0))))
    tx, ts = monte_carlo_search(torch.Generator(), torch.from_numpy(x0),
                                lambda x: -torch.sum((x - torch.from_numpy(c)) ** 2, dim=-1),
                                **kw)
    assert not noise
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.item(), float(js), atol=1e-6, rtol=0)
    assert np.abs(tx.numpy()).max() > 0.3  # premise: the incumbent moved


@pytest.mark.parametrize("maximize", [True, False])
def test_monte_carlo_search_converges(maximize):
    """tests/test_geometry_es.py's quadratic bowl and its minimize mode."""
    c = torch.tensor([1.0, -2.0, 0.5])
    sign = 1.0 if maximize else -1.0
    x, s = monte_carlo_search(torch.Generator().manual_seed(0), torch.zeros(3),
                              lambda x: -sign * torch.sum((x - c) ** 2, dim=-1),
                              n_offspring=32, n_iterations=200, noise_std=0.3,
                              temperature=0.1, maximize=maximize)
    assert torch.linalg.vector_norm(x - c).item() < 0.05
    assert abs(s.item()) < 0.01


def test_policy_es_converges_on_a_tree():
    """tests/test_geometry_es.py's pytree quadratic: NES drives a tree to
    the optimum of a known objective."""
    t_w = torch.tensor([1.0, -2.0, 0.5, 3.0, -1.0])
    t_b = torch.tensor([0.3, -0.7])

    def fitness(p, g, c):
        return -torch.sum((p["w"] - t_w) ** 2, -1) - torch.sum((p["b"] - t_b) ** 2, -1)

    from fpyv_tpu_torch.rl.es import policy_es
    trained, hist = policy_es(torch.Generator().manual_seed(0),
                              {"w": np.zeros(5, np.float32), "b": np.zeros(2, np.float32)},
                              fitness, n_perturbations=16, n_iterations=300, noise_std=0.3,
                              learning_rate=0.3, device="cpu")
    assert hist.shape == (300,)
    torch.testing.assert_close(trained["w"], t_w, atol=0.15, rtol=0)


# ---------------------------------------------------------------------------
# The ES trainer's pieces
# ---------------------------------------------------------------------------


def test_batched_forward_matches_flax():
    """actor_mean_batched over 4 candidates' unravelled theta against JAX's
    net.apply(unravel(c), obs) for each."""
    jnet, params = _ac_tree(seed=6)
    jtheta, junravel = ravel_pytree(params)
    rng = np.random.default_rng(6)
    cand = (np.asarray(jtheta)[None] + 0.3 * rng.normal(size=(4, jtheta.shape[0]))).astype(
        np.float32)
    obs = rng.normal(size=(4, 32, 17)).astype(np.float32)
    tree = interop.unravel_params(torch.from_numpy(cand), params)
    ours = actor_mean_batched(tree, torch.from_numpy(obs))
    for i in range(4):
        ref, _, _ = jnet.apply(junravel(jnp.asarray(cand[i])), jnp.asarray(obs[i]))
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("env_name", ["acro", "rotate"])
def test_common_random_numbers_hold_across_resets(env_name, monkeypatch):
    """Two candidates with equal theta get bit-equal fitness through every
    auto-reset (acro episodes of 4 steps in a 12-step rollout; rotate with a
    loose threshold); drawing per candidate instead, they differ."""
    monkeypatch.setattr(ttrain, "AcroEnv", functools.partial(AcroEnv, max_episode_steps=4))
    monkeypatch.setattr(ttrain, "RotateEnv", functools.partial(ttrain.RotateEnv, threshold=2.0))
    dones = []
    for mod, cls in ((ttrain, "AcroEnv"), (ttrain, "RotateEnv")):
        real = getattr(mod, cls)
        env_cls = real.func

        def spy_step(self, *a, _step=env_cls.step, **k):
            out = _step(self, *a, **k)
            dones.append(out[3])
            return out

        monkeypatch.setattr(env_cls, "step", spy_step)
    tr = make_es_trainer(env_name=env_name, num_envs=16, num_steps=12, n_perturbations=2,
                         hidden=(16, 16), device="cpu")
    theta = tr.state[0]
    cand = torch.stack([theta, theta, theta + 0.1, theta - 0.1])
    fits = tr.fitness(tr.unravel(cand), torch.Generator().manual_seed(0), True)
    assert fits[0].item() == fits[1].item()  # bit-equal
    assert fits[2].item() != fits[0].item()  # premise: theta matters
    assert sum(int(d[0].sum()) for d in dones) >= 4  # premise: envs reset on the way
    per_cand = tr.fitness(tr.unravel(cand), torch.Generator().manual_seed(0), False)
    assert per_cand[0].item() != per_cand[1].item()


@pytest.mark.parametrize("env_name", ["acro", "rotate"])
def test_train_es_on_the_cpu(env_name, tmp_path):
    import json

    res = train_es(env_name=env_name, num_envs=8, num_iterations=4, num_steps=6,
                   n_perturbations=4, hidden=(16, 16), scan_chunk=2, log_dir=str(tmp_path),
                   print_every=0, device="cpu")
    assert res.iterations == 4 and res.steps_per_second > 0
    assert np.isfinite(res.mean_reward_first) and np.isfinite(res.mean_reward_last)
    rows = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert all(np.isfinite(r["gen_best_fitness"]) for r in rows)


def test_train_es_distributed_runs_at_world_size_1(tmp_path):
    """``distributed=True`` with no process group: the one-rank mesh."""
    res = train_es(env_name="rotate", num_envs=8, num_iterations=2, num_steps=4,
                   n_perturbations=2, hidden=(8,), scan_chunk=1, print_every=0,
                   distributed=True, device="cpu")
    assert res.iterations == 2 and np.isfinite(res.mean_reward_last)


def test_train_es_refuses_what_is_not_ported():
    with pytest.raises(ValueError, match="unknown env"):
        train_es(env_name="ball", device="cpu")
