"""Each fault a cell can have (portbench/faults.py), planted underneath
the timed path, makes a small CPU run come out not correct under the
cells' own limits; so does the control, the reference computed in float8
put in the program's place. An unbroken small run comes out correct. The
sizes are the smallest at which the learner's and the actor's gaps read
as at the cells' own (race_rollout keeps its frame, for its policy)."""

from __future__ import annotations

import pytest

from portbench import faults
from portbench.tests.tiny import run_tiny, tiny_cell

CELLS = ("race_train", "race_rollout", "chase_rollout")


SIZES = {"race_train": dict(n=16, t=8, max_episode_steps=4),
         "race_rollout": dict(n=64, t=4, resolution=None, max_episode_steps=2),
         "chase_rollout": dict(n=4, t=6)}


def _found(cell):
    return tiny_cell(cell, **SIZES[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_an_unbroken_tiny_run_is_correct(cell):
    res = run_tiny(_found(cell))
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.KERNEL))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_kernel_is_not_correct(cell, fault):
    found = _found(cell)
    with faults.planted(found["cfg"], fault):
        res = run_tiny(found)
    assert not res["correct"] and res["failed"] >= 1, res["checks"]


@pytest.mark.parametrize("fault", faults.LEARNER)
def test_a_broken_learner_is_not_correct(fault):
    found = _found("race_train")
    with faults.planted(found["cfg"], fault):
        res = run_tiny(found)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    found = _found(cell)
    cfg, wl, driver = found["cfg"], found["wl"], found["driver"]
    s = driver.setup(cfg, wl, 2**31 + 11, "cpu")
    numbers = driver.check(cfg, s, control=True)
    assert any(not (v <= wl["limits"][k]) for k, v in numbers.items()), numbers
