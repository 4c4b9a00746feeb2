"""The ``acro_megaloop`` cell's check against faults planted in the
program underneath the timed path: each makes a run come out not correct,
and an unbroken run comes out correct. On the CPU at 64 envs, 100 steps
and 50-step episodes (K4's plain version); on the card (``cuda``) at the
cell's own size with a 2 s window:

    python -m pytest --noconftest -q portbench/tests/test_portbench_megaloop.py -m cuda
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from contextlib import contextmanager

import pytest
import torch

from portbench import run as prun
from portbench.tests.tiny import BENCH

SEED = 2**31 + 11


def _halve(state, rsum):
    """The second half of the envs replaced by the first."""
    from fpyv_tpu_torch.ops import env_kernel as ek

    mat, rsum = ek.env_state_to_matrix(state), rsum.clone()
    h = rsum.shape[0] // 2
    mat[:, h:2 * h] = mat[:, :h]
    rsum[h:2 * h] = rsum[:h]
    return ek.matrix_to_env_state(mat, state), rsum


def _state_unchanged(orig, env, state, action, world, n, seed):
    _, world, rsum = orig(env, state, action, world, n, seed)
    return state, world, rsum


def _half_the_envs(orig, env, state, action, world, n, seed):
    out, world, rsum = orig(env, state, action, world, n, seed)
    out, rsum = _halve(out, rsum)
    return out, world, rsum


FAULTS = {
    "state_unchanged": _state_unchanged,
    "half_the_envs": _half_the_envs,
    "dr_ignored": lambda orig, env, *a: orig(dataclasses.replace(env, randomize=False), *a),
    "wind_ignored": lambda orig, env, *a: orig(
        dataclasses.replace(env, wind=(0.0, 0.0, 0.0), wind_scale=0.0), *a),
    "seed_off_by_one": lambda orig, env, state, action, world, n, seed: orig(
        env, state, action, world, n, seed + 1),
}


@contextmanager
def planted(fault: str):
    """While open, ``fused_env_rollout`` runs with ``fault``."""
    from fpyv_tpu_torch.ops import env_kernel as ek

    orig = ek.fused_env_rollout

    def broken(env, state, action, world, n_steps, seed=0):
        return FAULTS[fault](orig, env, state, action, world, n_steps, seed)

    ek.fused_env_rollout = broken
    try:
        yield
    finally:
        ek.fused_env_rollout = orig


def _found(n=None, k=None, episode=None):
    found = prun.find_cell(BENCH, "acro_megaloop")
    cfg = copy.deepcopy(found["cfg"])
    if n:
        cfg["num_envs"], cfg["num_steps"] = n, k
        cfg["acro"]["max_episode_steps"] = episode
    return dict(found, cfg=cfg)


def _run(found, device, seconds):
    return prun.run_cell(found, SEED, seconds, False, device, start=time.perf_counter())


def _broken(res):
    return not res["correct"] and res["failed"] >= 1


TINY = dict(n=64, k=100, episode=50)


def test_an_unbroken_tiny_run_is_correct():
    res = _run(_found(**TINY), "cpu", 0.2)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_megaloop_is_not_correct(fault):
    with planted(fault):
        res = _run(_found(**TINY), "cpu", 0.2)
    assert _broken(res), res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_the_cell_on_the_card(card, fault, capsys):
    if fault is None:
        res = _run(_found(), "cuda", 2.0)
        ok = res["correct"] and all(c["value"] == 0 for c in res["checks"].values())
    else:
        with planted(fault):
            res = _run(_found(), "cuda", 2.0)
        ok = _broken(res)
    with capsys.disabled():
        print(json.dumps({"fault": fault, "attempted": res["attempted"],
                          "checks": res["checks"]}))
    assert ok, res["checks"]


def test_a_traced_run_reads_the_megaloops_metrics(capsys):
    from fpyv_tpu_torch.utils import profiling

    profiling.clear_spans()
    res = prun.run_cell(_found(n=8, k=4, episode=3), SEED, 0.5, True, "cpu",
                        start=time.perf_counter())
    m = res["metrics"]
    assert m["megaloop_host_ms"]["value"] > 0 and m["host_syncs.megaloop"]["value"] == 0
    # the plain version runs no kernel and no device: the device metrics read nothing
    assert "k4_roofline" not in m and "device_idle.rollout" not in m
    err = capsys.readouterr().err
    assert "host_syncs.megaloop over 20 roots" in err and "  megaloop.launch " in err
    profiling.clear_spans()
    res = prun.run_cell(_found(n=8, k=4, episode=3), SEED, 0.2, False, "cpu",
                        start=time.perf_counter())
    assert profiling.spans() == [] and "rollout_env_steps_per_s" in res["metrics"]
    host_ms = prun.load_file(prun.HERE / "metrics" / "megaloop_host_ms.py")
    assert host_ms.read({"trace": None, "megaloop_call_ms": None}) is None


def test_k4_roofline_reads_the_kernels_trace():
    found = _found()
    mod = prun.load_file(prun.HERE / "metrics" / "k4_roofline.py")
    kernels = {"void (anonymous namespace)::env_rollout_kernel<4, 4, true, true>(...)":
               [20 * 4.5e-3, 20],
               "void (anonymous namespace)::vision_env_rollout_kernel<...>(...)": [1.0, 1]}
    ctx = {"trace": {"kernels": kernels}, "cfg": found["cfg"], "ends_per_launch": 9000}
    from portbench import counts, counts_env

    least = counts.least_seconds(counts_env.launch_work(found["cfg"], resets=9000))
    assert mod.read(ctx) == pytest.approx(100 * least / 4.5e-3)
    assert 3 < mod.read(ctx) < 6
    assert mod.read(dict(ctx, trace=None)) is None
    assert mod.read(dict(ctx, cfg={"kernel": "race_vision_rollout"})) is None
