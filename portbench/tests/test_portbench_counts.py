"""The frozen work counts hold the bounds the port's kernel table gives K7
and K8 at chip_smoke.py's shapes, and give the cells' own."""

from __future__ import annotations

import json

import pytest

from portbench import counts
from portbench.tests.tiny import REPO


def _ms(work):
    return counts.least_seconds(work) * 1e3


def test_k7_bound_at_the_kernel_tables_shape():
    # 1024 envs, T = 32, 96x72, one sphere and four cylinders, bf16
    assert round(_ms(counts.k7_launch(1024, 32, 96 * 72, 1, 4)), 6) == 0.920221


def test_k8_bound_at_the_kernel_tables_shape():
    # 1024 races, T = 32, 96x72, 4 frames, no obstacles, 6 live gates, bf16
    assert round(_ms(counts.k8_launch(1024, 32, 96 * 72, 0, 6, 4)), 6) == 1.920379


def test_each_live_primitive_costs_its_ray_test():
    base = counts.render_ops(0, 0, 0)
    assert counts.render_ops(3, 0, 0) - base == 5 + 3 * 33
    assert counts.render_ops(0, 4, 0) - base == 4 * 50
    assert counts.render_ops(0, 0, 6) - base == 6 * 89


@pytest.mark.parametrize("name,flops", [("race_k8", 14_163_968), ("chase_k7", 8_852_480)])
def test_the_policys_forward_flops(name, flops):
    cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
    assert counts.forward_flops(cfg) == flops


def test_the_race_cells_launch_is_bound_by_operations():
    cfg = json.loads((REPO / "portbench" / "configs" / "race_k8.json").read_text())
    work = counts.launch_work(cfg)
    assert counts.least_seconds(work) == work["ops"] / counts.PEAK_F32_OPS
    assert 2.2e-3 < counts.least_seconds(work) < 2.35e-3
    # an iteration: 32 rollout forwards, 1 bootstrap, 3 x 2 epochs, per env
    assert counts.iteration_flops(cfg) == 14_163_968 * 1024 * (32 + 1 + 6 * 32)
