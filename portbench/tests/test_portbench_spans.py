"""The metrics that read the program's spans (portbench/spans.py): each
reads a number in a traced run of its cells at their tiny CPU sizes, and
nothing from an untraced one, where the profiler never ran and no span was
recorded."""

from __future__ import annotations

import json
import time

import pytest

from fpyv_tpu_torch.utils import profiling
from portbench import run as prun
from portbench.tests.tiny import REPO, tiny_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"
                and m["name"] != "learner_ms"]
CELLS = ("race_train", "race_rollout", "chase_rollout")


def _mine(cell):
    return [m for m in SPAN_METRICS if cell in m["workloads"]]


def _run(cell, trace):
    """A run of the cell at 4 envs, 6 steps and a 16x8 frame: a call takes
    well under the window's first half, so the traced calls run."""
    profiling.clear_spans()
    return prun.run_cell(tiny_cell(cell), 2**31 + 7, 0.5, trace, "cpu",
                         start=time.perf_counter())


def test_six_span_metrics_cover_the_three_cells():
    assert sorted(m["name"] for m in SPAN_METRICS) == sorted(
        ["ppo_learn_ms", "ppo_backward_ms", "ppo_step_ms", "host_syncs.train",
         "rollout_host_ms", "host_syncs.rollout"])
    assert all(_mine(cell) for cell in CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_each_span_metric(cell, capsys):
    res = _run(cell, True)
    for m in _mine(cell):
        v = res["metrics"][m["name"]]["value"]
        assert v >= 0 and m["unit"] == res["metrics"][m["name"]]["unit"]
        if m["unit"] == "ms":
            assert v > 0, m["name"]
    err = capsys.readouterr().err
    root = "ppo.iteration" if cell == "race_train" else "rollout"
    for m in _mine(cell):
        assert f"{m['name']} over " in err
    assert f"  {root} " in err and "rollout.launch" in err
    if cell == "race_train":
        learn = res["metrics"]["ppo_learn_ms"]["value"]
        assert res["metrics"]["ppo_backward_ms"]["value"] < learn
        assert res["metrics"]["ppo_step_ms"]["value"] < learn


@pytest.mark.parametrize("cell", CELLS)
def test_an_untraced_run_reads_none(cell):
    _run(cell, False)
    assert profiling.spans() == []
    for m in _mine(cell):
        mod = prun.load_file(prun.HERE / "metrics" / f"{m['name']}.py")
        assert mod.read({"trace": None, "kind": "train"}) is None
        # a traced context finds no span either: nothing ran under the profiler
        assert mod.read({"trace": {"busy_s": 1.0}, "kind": "train"}) is None
