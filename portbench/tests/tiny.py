"""Tiny versions of the benchmark's cells that a CPU test can run: the
port's plain kernel versions stand in for K7 and K8, at a few envs, a
few steps and a 16x8 frame (two patches)."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

from portbench import run as prun

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def tiny_cell(cell: str, n: int = 4, t: int = 6, resolution=(16, 8), max_episode_steps=None):
    """The found cell (run.find_cell) cut to ``n`` envs, ``t`` steps and a
    ``resolution`` frame (None keeps the cell's); the race's episodes may
    be cut to force ends. A cell's policy file stays in only at its own
    frame (its widths are that frame's)."""
    found = prun.find_cell(BENCH, cell)
    cfg = copy.deepcopy(found["cfg"])
    cfg["num_envs"], cfg["num_steps"] = n, t
    cfg["entry_kwargs"].update(num_envs=n, num_steps=t)
    if resolution is not None:
        cfg["camera"]["resolution"] = list(resolution)
    if "ppo" in cfg:
        cfg["ppo"]["num_steps"] = t
    if max_episode_steps:
        cfg["entry_kwargs"]["max_episode_steps"] = max_episode_steps
        cfg["race"]["max_episode_steps"] = max_episode_steps
    wl = dict(found["wl"])
    if resolution is not None:
        wl.pop("policy", None)
    return dict(found, cfg=cfg, wl=wl)


def run_tiny(found, seed: int = 2**31 + 7, seconds: float = 0.2):
    return prun.run_cell(found, seed, seconds, False, "cpu", start=time.perf_counter())
