"""The port's trainers with ``distributed=True``: at world size 1 (no
process group, the one-rank mesh) every trainer equals its single-process
run bit for bit; at world size 2 over gloo on the CPU
(``fpyv_tpu_torch.parallel.launch``; the ranks' side is
``tests/torch_dist_ranks.py``) the four sub-checks of
``__graft_entry__.py::dryrun_multichip`` pass, a resumed run equals an
unbroken one and the curriculum hands each rank its slice of the same
worlds; the refusals JAX keeps, and the ones of the process group itself.

Each sub-check needs a finite loss, replicas equal bit for bit, and an info
that is the mean of the ranks' own infos (their float32 mean, exactly, as
one all-reduce sums two values and halves the sum); ES's theta and
generation-best fitness are also held to world size 1, within 1e-6 (the
ranks evaluate the same candidates in batches of another size). Each
launch has a 120 s deadline.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_dist_ranks as ranks
from fpyv_tpu_torch.apps import train as tapp
from fpyv_tpu_torch.apps.train import (
    _chunk_generator,
    make_race_trainer,
    make_vision_race_trainer,
    race_rollout,
    train_acro,
    train_es,
    train_race,
    train_vision,
    train_vision_race,
    vision_rollout,
)
from fpyv_tpu_torch.parallel.launch import launch
from fpyv_tpu_torch.parallel.mesh import Mesh, make_mesh
from fpyv_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint
from fpyv_tpu_torch.world.randomize import curriculum_worlds

W = 2
DEADLINE = 120.0


def _equal_trees(a, b):
    flat_a, flat_b = _leaves(a), _leaves(b)
    assert len(flat_a) == len(flat_b) > 5
    for x, y in zip(flat_a, flat_b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


# ---------------------------------------------------------------------------
# World size 1 equals one process
# ---------------------------------------------------------------------------


def _small(kind):
    if kind == "acro":
        return train_acro, dict(num_envs=8, num_steps=4, hidden=(16, 16))
    if kind == "race":
        return train_race, dict(num_envs=4, n_agents=2, num_steps=4, hidden=(16, 16),
                                max_episode_steps=6)
    return train_vision, dict(num_envs=8, num_steps=4, rig=ranks.vision_rig(), rollout="scan",
                              compute_dtype="f32", num_minibatches=2, update_epochs=1)


@pytest.mark.parametrize("kind", ["acro", "race", "vision", "es"])
def test_distributed_world_size_1_equals_one_process(kind, tmp_path):
    """Three iterations with ``distributed=True`` and no process group
    against ``distributed=False``: the same rewards, the same metrics log
    and, for the PPO trainers, the same checkpoint (the net, Adam, the env
    carry, the last obs, the generator), bit for bit."""
    runs = {}
    for distributed in (False, True):
        d = tmp_path / str(distributed)
        if kind == "es":
            res = train_es(env_name="acro", num_envs=4, num_iterations=3, num_steps=5,
                           n_perturbations=2, hidden=(8,), scan_chunk=1, log_dir=str(d),
                           print_every=0, distributed=distributed, device="cpu")
        else:
            train, kw = _small(kind)
            res = train(num_iterations=3, scan_chunk=2, checkpoint_dir=str(d / "ck"),
                        checkpoint_every=3, log_dir=str(d), print_every=0,
                        distributed=distributed, device="cpu", **kw)
        rows = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        runs[distributed] = (res, [{k: v for k, v in r.items() if k != "time"} for r in rows])
    (a, rows_a), (b, rows_b) = runs[False], runs[True]
    assert (a.mean_reward_first, a.mean_reward_last) == (b.mean_reward_first, b.mean_reward_last)
    assert rows_a == rows_b and len(rows_a) == 3
    if kind != "es":
        _equal_trees(restore_checkpoint(str(tmp_path / "False" / "ck"), 3),
                     restore_checkpoint(str(tmp_path / "True" / "ck"), 3, shard=(0, 1)))


# ---------------------------------------------------------------------------
# dryrun_multichip's four sub-checks at world size 2
# ---------------------------------------------------------------------------


def _averaged(outs, info_at=0, local_at=1):
    """The ranks' infos are equal, finite, and the float32 mean of their
    own infos."""
    infos = [o[info_at] for o in outs]
    assert infos[0] == infos[1]
    assert np.isfinite(infos[0]["loss"])
    for k, v in infos[0].items():
        mine = [np.float32(o[local_at][k]) for o in outs]
        assert np.float32(v) == (mine[0] + mine[1]) / np.float32(2), k


def _replicas(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("check", ["acro", "vision", "es", "race"])
def test_dryrun_multichip_at_world_size_2(check):
    """``dryrun_multichip``'s sub-checks over two ranks: acro PPO (the bank
    split, rank 0's weights broadcast), vision PPO (the pytree observation
    and the per-env worlds in the carry), ES with the population split, and
    the shared-policy race (whole races a rank)."""
    if check == "acro":
        outs = launch(ranks.dryrun_acro, W, (16,), deadline=DEADLINE)
        _averaged(outs)
        _replicas(outs[0][2], outs[1][2])
        assert outs[0][1]["mean_reward"] != outs[1][1]["mean_reward"]  # premise: own halves
    elif check == "vision":
        outs = launch(ranks.dryrun_vision, W, (8,), deadline=DEADLINE)
        _averaged(outs)
        _replicas(outs[0][2], outs[1][2])
        assert outs[0][4] == ["accel_z", "pixels", "rates", "thrust"]
        # each rank rolled out in its own 4 worlds, the whole bank's rows
        centres = np.concatenate([outs[0][3], outs[1][3]])
        assert centres.shape[0] == 8 and not np.array_equal(outs[0][3], outs[1][3])
    elif check == "es":
        one = ranks.dryrun_es(None, 4, 2)
        outs = launch(ranks.dryrun_es, W, (4, 2), deadline=DEADLINE)
        for theta, hist in outs:
            np.testing.assert_array_equal(theta, outs[0][0])
            np.testing.assert_allclose(theta, one[0], atol=1e-6, rtol=0)
            np.testing.assert_allclose(hist, one[1], atol=1e-6, rtol=0)
        assert np.isfinite(one[1]).all() and np.abs(one[0]).max() > 0
    else:
        outs = launch(ranks.dryrun_race, W, (8, 2), deadline=DEADLINE)
        _averaged(outs)
        _replicas(outs[0][2], outs[1][2])
        assert outs[0][3] == (4, 2) and "mean_gates_passed" in outs[0][0]


# ---------------------------------------------------------------------------
# Resume, the curriculum, the refusals
# ---------------------------------------------------------------------------


def test_two_rank_resume_equals_unbroken_run(tmp_path):
    """Each rank's step-4 shard of 4 iterations in one run equals its shard
    of 2 + a resume for 2 more; a step counts once all its shards are
    there, and another world size cannot resume them."""
    assert launch(ranks.resume_runs, W, (str(tmp_path),), deadline=DEADLINE) == [0, 1]
    for r in range(W):
        a = restore_checkpoint(str(tmp_path / "whole"), 4, shard=(r, W))
        b = restore_checkpoint(str(tmp_path / "split"), 4, shard=(r, W))
        assert a["update_count"] == b["update_count"] == 4
        _equal_trees(a, b)
        c = restore_checkpoint(str(tmp_path / "split"), 2, shard=(r, W))
        assert not torch.equal(c["last_obs"], b["last_obs"])  # premise: the envs moved
        assert c["last_obs"].shape[0] == 4  # premise: the rank's half of the bank
    split = tmp_path / "split"
    assert latest_step(str(split), world_size=W) == 4
    (split / "step_0000000004.rank1of2.pt").unlink()
    assert latest_step(str(split), world_size=W) == 2
    with pytest.raises(ValueError, match="world size"):
        train_acro(num_envs=8, num_iterations=1, num_steps=4, hidden=(16, 16),
                   checkpoint_dir=str(split), resume=True, device="cpu")


def test_curriculum_hands_each_rank_its_slice():
    """The curriculum hook over two ranks: each rank's new worlds are its
    rows of the whole bank's, drawn from the chunk's generator."""
    outs = launch(ranks.curriculum_slice, W, (8, 0, 2), deadline=DEADLINE)
    whole = curriculum_worlds(_chunk_generator(0, 2), 8, 0.5, device="cpu")
    for f in dataclasses.fields(whole):
        got = np.concatenate([o[f.name] for o in outs])
        np.testing.assert_array_equal(got, getattr(whole, f.name).numpy(), err_msg=f.name)
    first = curriculum_worlds(_chunk_generator(0, 0), 8, 0.0, device="cpu")
    assert not torch.equal(first.sphere_center, whole.sphere_center)  # premise: a new draw


def test_auto_routes_distributed_to_the_scan_rollout(capsys):
    """As JAX routes it (fpyv_tpu/apps/train.py:613, :902): ``auto`` never
    takes K7 or K8 with ``distributed``."""
    assert vision_rollout("auto") == "kernel"
    assert vision_rollout("auto", distributed=True) == "scan"
    assert race_rollout("auto") == "kernel"
    assert race_rollout("auto", distributed=True) == "scan"


@pytest.mark.parametrize("case", ["vision-kernel", "race-kernel", "race-gru", "races",
                                  "vision-races"])
def test_distributed_refuses_what_jax_refuses(case):
    """JAX's refusals: K7 and K8 with ``distributed`` (:909-911, :624-626),
    the GRU with it (:618-619), and races that do not split whole over the
    ranks (:229-231, :712-714), raised before any rank joins (a two-rank
    layout, no process group)."""
    two = Mesh("env", 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError) as err:
        if case == "vision-kernel":
            train_vision(num_envs=8, rollout="kernel", distributed=True, device="cpu")
        elif case == "race-kernel":
            train_vision_race(num_envs=8, rollout="kernel", distributed=True, device="cpu")
        elif case == "race-gru":
            train_vision_race(num_envs=8, gru=8, distributed=True, device="cpu")
        elif case == "races":
            make_race_trainer(num_envs=3, n_agents=2, device="cpu", mesh=two)
        else:
            make_vision_race_trainer(num_envs=3, rollout="scan", device="cpu", mesh=two)
    want = {"vision-kernel": "distributed", "race-kernel": "no distributed",
            "race-gru": "gru \\+ distributed"}.get(case, "whole races per shard")
    assert err.match(want)


def test_nccl_refuses_two_ranks_on_one_device():
    """NCCL takes one rank per GPU: rank 1 asking for cuda:0 raises, naming
    gloo, before it joins anything (no fallback to gloo)."""
    with pytest.raises(ValueError, match="gloo"):
        make_mesh(init_method="file:///nonexistent/store", rank=1, world_size=2,
                  backend="nccl", device="cuda:0")


def test_distributed_on_cuda_without_cuda_raises(monkeypatch):
    """``distributed=True`` on the default device (CUDA) where CUDA is
    missing raises, as every entry point does; it does not take the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_acro(num_envs=8, num_iterations=1, distributed=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(init_method="file:///nonexistent/store", rank=0, world_size=2,
                  backend="gloo")


def test_rank_zero_alone_logs(tmp_path, monkeypatch):
    """Over a mesh only rank 0 writes the metrics log, and every rank's
    meter counts the global env-steps."""
    seen = []
    real = tapp.MetricsLogger

    def spy(log_dir=None, print_every=0):
        seen.append((log_dir, print_every))
        return real(log_dir, print_every)

    monkeypatch.setattr(tapp, "MetricsLogger", spy)
    state = object()
    for rank in (0, 1):
        res = tapp._train_loop(state, lambda s: (s, {"mean_reward": torch.tensor(1.0)}),
                               num_envs=16, num_steps=4, num_iterations=2, start_iter=0,
                               scan_chunk=1, log_dir=str(tmp_path), print_every=1,
                               checkpoint_dir=None, checkpoint_every=1,
                               mesh=Mesh("env", rank, 2, torch.device("cpu")))
        assert res.steps_per_second > 0
    assert seen == [(str(tmp_path), 1), (None, 0)]
