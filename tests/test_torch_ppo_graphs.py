"""The PPO learner's CUDA-graph path (``rl.ppo._Graphs``) as the CPU sees
it: a CPU learner runs eagerly, records no ``ppo.replay`` or
``ppo.capture`` span and updates exactly as the eager loop written out
here (the learner before the graphs: the epoch's shuffle by indexing, then
``_minibatch`` a minibatch); the graphs' bookkeeping (which iteration runs
eagerly, captures or replays; the static inputs the shuffle fills) with a
stand-in whose replay runs the captured update eagerly, again exactly as
the eager loop; which learners may take the graphs; the optimizer
``make_optimizer`` gives and what a loaded state keeps; the pixel net's
device-resident 255, bit-equal to a division by ``device.divisor``, and its
unchanged state-dict keys. The graphs themselves run on the card
(``tests/test_torch_cuda.py::test_cuda_ppo_graphs_*``). Imports neither JAX
nor ``fpyv_tpu``:

    python -m pytest --noconftest -q tests/test_torch_ppo_graphs.py
"""

from __future__ import annotations

import contextlib
import dataclasses
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.models.policy import ActorCritic, PixelActorCritic
from fpyv_tpu_torch.rl import ppo
from fpyv_tpu_torch.rl.gae import compute_gae
from fpyv_tpu_torch.utils import profiling

N, T, OBS, ACT = 16, 4, 3, 2


@pytest.fixture(autouse=True)
def fresh_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _apply(net, obs):
    return net(obs)


def _env_step(env_state, action, generator):
    nxt = env_state + 0.1 * action.sum(-1, keepdim=True)
    reward = -(nxt * nxt).sum(-1)
    return nxt, nxt, reward, reward < -4.0


def _config(**kw):
    return ppo.PpoConfig(num_envs=N, num_steps=T, update_epochs=2, num_minibatches=4,
                         shuffle_block=4, **kw)


def _start(seed=0):
    g = torch.Generator().manual_seed(seed)
    net = ActorCritic(action_dim=ACT, obs_dim=OBS, hidden=(8, 8)).init_params(g)
    obs = torch.randn(N, OBS, generator=g)
    return net, obs, torch.Generator().manual_seed(seed + 1)


def _eager_iteration(net, opt, gen, env_state, obs, config):
    """One iteration of the learner as it ran before the graphs: the
    per-step rollout, GAE, then each epoch's block shuffle by indexing and
    ``_minibatch`` on each slice of it."""
    state = ppo.PpoState(net, opt, env_state, obs, gen, 0)
    with torch.no_grad():
        env_state, last_obs, traj = ppo.make_step_rollout(_apply, _env_step, config)(state)
        _, _, last_value = _apply(net, last_obs)
        adv, tgt = compute_gae(traj.reward, traj.value, traj.done, last_value, config.gamma,
                               config.gae_lambda)
        batch = ppo.Transition(**{f.name: getattr(traj, f.name).reshape(
            (T * N,) + tuple(getattr(traj, f.name).shape[2:]))
            for f in dataclasses.fields(ppo.Transition)})
        adv, tgt = adv.reshape(-1), tgt.reshape(-1)
    block, mb = config.shuffle_block, T * N // config.num_minibatches
    losses, metrics = [], {}
    for _ in range(config.update_epochs):
        perm = ppo.permutation(T * N // block, gen, "cpu")

        def shuffle(x):
            return x.reshape((-1, block) + tuple(x.shape[1:]))[perm].reshape(x.shape)

        sh = ppo.Transition(**{f.name: shuffle(getattr(batch, f.name))
                               for f in dataclasses.fields(ppo.Transition)})
        adv_sh, tgt_sh = shuffle(adv), shuffle(tgt)
        for i in range(config.num_minibatches):
            sl = slice(i * mb, (i + 1) * mb)
            m = ppo.Transition(**{f.name: getattr(sh, f.name)[sl]
                                  for f in dataclasses.fields(ppo.Transition)})

            def loss_fn():
                mean, log_std, value = _apply(net, m.obs)
                log_prob = ppo.gaussian_log_prob(mean, log_std, m.action)
                return ppo._ppo_terms(config, m, log_prob, value, log_std, adv_sh[sl],
                                      tgt_sh[sl])

            ppo._minibatch(net, opt, config, loss_fn, losses, metrics)
    return env_state, last_obs, torch.stack(losses).mean()


def test_a_cpu_learner_runs_eagerly_and_updates_as_the_eager_loop():
    config = _config()
    net, obs, gen = _start()
    init, train_iteration = ppo.make_ppo(_apply, _env_step, config)
    state = init(net, obs.clone(), obs.clone(), gen)
    twin, _, twin_gen = _start()
    twin_opt = torch.optim.Adam(twin.parameters(), lr=config.learning_rate, eps=1e-5)
    env_state = last_obs = obs.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            state, info = train_iteration(state)
            env_state, last_obs, loss = _eager_iteration(twin, twin_opt, twin_gen, env_state,
                                                         last_obs, config)
            assert torch.equal(info["loss"], loss)
    for (k, a), (_, b) in zip(state.params.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), k
    assert torch.equal(state.last_obs, last_obs)
    recs = profiling.spans()
    roots = {r.index for r in recs if r.name == "ppo.iteration"}
    names = [r.name for r in recs if r.root in roots]  # the twin's spans left out
    assert len(roots) == 3 and "ppo.replay" not in names and "ppo.capture" not in names
    assert names.count("ppo.minibatch") == names.count("ppo.backward") == 3 * 2 * 4
    assert not state.opt_state.param_groups[0]["capturable"]


class _EagerGraph:
    """A stand-in for a captured update on the CPU: its replay runs the
    captured function eagerly on the static inputs as they are then, and
    writes its loss and terms where the graph's outputs live (the terms'
    tensors appear at the first replay)."""

    def __init__(self, run):
        self.run, self.loss, self.terms = run, torch.zeros(()), {}

    def replay(self):
        losses, metrics = [], {}
        self.run(losses, metrics)
        self.loss.copy_(losses[0])
        for k, v in metrics.items():
            self.terms.setdefault(k, torch.zeros(())).copy_(v[0])


@pytest.fixture
def eager_graphs(monkeypatch):
    """``rl.ppo._Graphs`` on the CPU: every learner graphable, the streams
    inert, and each capture a list of :class:`_EagerGraph`; yields the
    captures made (each one's minibatch count)."""
    captures = []

    class Stream:
        def __init__(self, device=None):
            self.device = torch.device(device or "cpu")

        def wait_stream(self, other):
            pass

    def capture(self, net, opt, config, loss_fns):
        captures.append(config.num_minibatches)
        for i in range(config.num_minibatches):
            fn = loss_fns(i)
            g = _EagerGraph(lambda losses, metrics, fn=fn: ppo._minibatch(
                net, opt, config, fn, losses, metrics))
            self.graphs.append((g, g.loss, g.terms))

    monkeypatch.setattr(ppo, "_graphable", lambda *a: True)
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream(device))
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(ppo._Graphs, "_capture", capture)
    yield captures


def test_the_graphs_bookkeeping_with_replays_run_eagerly(eager_graphs):
    """The first iteration eager, the second captures every position and
    replays, the third replays; after ``opt.load_state_dict`` one eager
    iteration, then a capture; a swapped ``_update`` captures again. Replays
    read the static inputs that the shuffle filled, so the learner updates
    exactly as the eager loop."""
    config = _config()
    net, obs, gen = _start()
    init, train_iteration = ppo.make_ppo(_apply, _env_step, config)
    state = init(net, obs.clone(), obs.clone(), gen)
    twin, _, twin_gen = _start()
    twin_opt = torch.optim.Adam(twin.parameters(), lr=config.learning_rate, eps=1e-5)
    env_state = last_obs = obs.clone()
    counts = []
    for it in range(6):
        if it == 3:
            opt = state.opt_state
            opt.load_state_dict({"state": {i: {k: v.clone() for k, v in st.items()}
                                           for i, st in opt.state_dict()["state"].items()},
                                 "param_groups": opt.state_dict()["param_groups"]})
        profiling.clear_spans()
        with profile(activities=[ProfilerActivity.CPU]):
            state, info = train_iteration(state)
        names = [r.name for r in profiling.spans()]
        counts.append((names.count("ppo.replay"), names.count("ppo.capture")))
        env_state, last_obs, loss = _eager_iteration(twin, twin_opt, twin_gen, env_state,
                                                     last_obs, config)
        assert torch.equal(info["loss"], loss), it
    assert counts == [(0, 0), (8, 1), (8, 0), (0, 0), (8, 1), (8, 0)]
    for (k, a), (_, b) in zip(state.params.state_dict().items(), twin.state_dict().items()):
        assert torch.equal(a, b), k
    assert eager_graphs == [4, 4]


def test_a_swapped_update_is_captured_again(eager_graphs, monkeypatch):
    config = _config()
    net, obs, gen = _start()
    init, train_iteration = ppo.make_ppo(_apply, _env_step, config)
    state = init(net, obs.clone(), obs.clone(), gen)
    for _ in range(2):
        state, _ = train_iteration(state)
    before = [p.detach().clone() for p in net.parameters()]

    def no_step(net, opt, loss, config):
        opt.zero_grad(set_to_none=True)
        loss.backward()

    monkeypatch.setattr(ppo, "_update", no_step)
    for _ in range(2):
        state, _ = train_iteration(state)
    assert eager_graphs == [4, 4]
    assert all(torch.equal(a, p) for a, p in zip(before, net.parameters()))


def test_only_a_cuda_learner_with_the_capturable_adam_and_no_axis_may_replay():
    config = _config()
    net, _, _ = _start()
    adam = ppo.make_optimizer(net, config, capturable=True)
    assert type(adam) is torch.optim.Adam and not adam.param_groups[0]["capturable"]
    assert not ppo._graphable(net, adam, config)  # the parameters are on the CPU
    assert isinstance(ppo.make_optimizer(net, _config(adam_mu_dtype="bf16"), capturable=True),
                      ppo.AdamBf16Mu)

    class Subclass(torch.optim.Adam):
        pass

    # a net whose parameters are on CUDA, as the check sees them
    cuda_net = SimpleNamespace(parameters=lambda: [SimpleNamespace(is_cuda=True)])
    w = [torch.nn.Parameter(torch.zeros(2))]
    capturable = torch.optim.Adam(w, lr=1e-3, capturable=True)
    assert ppo._graphable(cuda_net, capturable, config)
    assert not ppo._graphable(cuda_net, capturable, _config(axis_name="env"))
    assert not ppo._graphable(cuda_net, torch.optim.Adam(w, lr=1e-3), config)
    assert not ppo._graphable(cuda_net, Subclass(w, lr=1e-3, capturable=True), config)
    assert not ppo._graphable(cuda_net, ppo.AdamBf16Mu(w, lr=1e-3), config)


def test_the_graph_key_sees_a_loaded_state_and_a_swapped_update(monkeypatch):
    config = _config()
    net, obs, gen = _start()
    init, train_iteration = ppo.make_ppo(_apply, _env_step, config)
    state, _ = train_iteration(init(net, obs.clone(), obs.clone(), gen))
    opt = state.opt_state
    key = ppo._graph_key(net, opt)
    assert ppo._graph_key(net, opt) == key
    opt.load_state_dict({"state": {i: {k: v.clone() for k, v in s.items()}
                                   for i, s in opt.state_dict()["state"].items()},
                         "param_groups": opt.state_dict()["param_groups"]})
    moved = ppo._graph_key(net, opt)
    assert moved != key
    opt.param_groups[0]["lr"] *= 0.5
    assert ppo._graph_key(net, opt) != moved
    opt.param_groups[0]["lr"] *= 2.0
    assert ppo._graph_key(net, opt) == moved
    monkeypatch.setattr(ppo, "_update", lambda *a: None)
    assert ppo._graph_key(net, opt) != moved


def test_a_loaded_state_keeps_the_optimizers_capturable_flag():
    """A state written by a capturable Adam (the card's learner) loads into
    the CPU's and steps there; a CPU state keeps the CPU's steps."""
    config = _config()
    net, _, _ = _start()
    writer = torch.optim.Adam(net.parameters(), lr=1e-3, eps=1e-5)
    net(torch.ones(1, OBS))[2].sum().backward()
    writer.step()
    saved = writer.state_dict()
    saved["param_groups"][0]["capturable"] = True
    opt = ppo.make_optimizer(net, config, capturable=True)
    opt.load_state_dict(saved)
    assert not opt.param_groups[0]["capturable"]
    steps = [st["step"] for st in opt.state.values()]
    assert all(s.device.type == "cpu" and s.dtype == torch.float32 and float(s) == 1.0
               for s in steps)
    opt.step()
    assert all(float(st["step"]) == 2.0 for st in opt.state.values())


def _pixel_net(torso, frame_stack=1):
    return PixelActorCritic(action_dim=4, n_patches=(16 * 8) // 64, proprio_dim=5,
                            torso=torso, image_hw=(8, 16), frame_stack=frame_stack,
                            hidden=(32,), embed=16).init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("torso,frame_stack,dtype", [
    ("patch", 1, torch.bfloat16), ("patch", 2, None), ("conv", 1, torch.bfloat16),
    ("conv", 2, None)])
def test_the_pixel_net_divides_uint8_levels_by_its_own_255_bit_equal(torso, frame_stack,
                                                                        dtype):
    net = _pixel_net(torso, frame_stack)
    net.compute_dtype = dtype
    g = torch.Generator().manual_seed(1)
    shape = (6,) + ((frame_stack,) if frame_stack > 1 else ()) + (8, 16)
    levels = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    proprio = torch.randn(6, 5, generator=g)
    assert net.level_scale.dtype == torch.float32 and float(net.level_scale) == 255.0
    assert net.level_scale.device == net.log_std.device
    old = levels.to(torch.float32) / divisor(255.0, levels)
    assert torch.equal(levels.to(torch.float32) / net.level_scale, old)
    assert torch.equal(net.features(levels, proprio), net.features(old, proprio))
    for a, b in zip(net(levels, proprio), net(old, proprio)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("torso", ["patch", "conv"])
def test_the_pixel_nets_state_dict_keys_are_its_parameters(torso):
    net = _pixel_net(torso)
    assert "level_scale" in dict(net.named_buffers())
    assert sorted(net.state_dict()) == sorted(n for n, _ in net.named_parameters())
    fresh = _pixel_net(torso)
    fresh.load_state_dict(net.state_dict(), strict=True)
    assert float(fresh.level_scale) == 255.0
