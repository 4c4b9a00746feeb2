"""The port's span recorder (``fpyv_tpu_torch.utils.profiling.span``) on
the CPU: nothing recorded with the profiler off, records that nest under
``torch.profiler`` with the profiler's own ranges around their ops, self
times, the sync counter, the learner's and the kernel rollouts' span trees
on tiny CPU trainers (the plain kernel versions), and the same parameters
with and without the profiler. Imports neither JAX nor ``fpyv_tpu``; the
one card case skips without a CUDA device:

    python -m pytest --noconftest -q tests/test_torch_profiling.py
"""

from __future__ import annotations

import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fpyv_tpu_torch.apps.train import make_vision_race_trainer, make_vision_trainer, train_acro
from fpyv_tpu_torch.utils import profiling
from fpyv_tpu_torch.utils.profiling import SYNC_MESSAGE, SpanRecord, self_ns, span, spans
from fpyv_tpu_torch.vision.camera import CameraRig


@pytest.fixture(autouse=True)
def fresh_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _children(records, parent):
    return [r for r in records if r.parent == parent.index]


def test_a_span_with_the_profiler_off_is_the_shared_null_context():
    a, b = span("a"), span("b")
    assert a is b is profiling._NULL
    with span("outer"):
        with span("inner"):
            (torch.ones(8) * 2).sum()
    assert spans() == []


def test_spans_nest_and_the_profiler_ranges_cover_their_ops():
    x = torch.ones(32, 32)

    def work():
        with span("outer") as outer:
            with span("inner.mm"):
                x @ x
            with span("inner.add"):
                x + x
        with span("second"):
            x * 2
        return outer

    prof, outer = _profiled(work)
    recs = spans()
    assert [(r.index, r.name, r.root, r.parent) for r in recs] == [
        (0, "outer", 0, -1), (1, "inner.mm", 0, 0), (2, "inner.add", 0, 0),
        (3, "second", 3, -1)]
    assert recs[0] is outer and all(r.end_ns >= r.start_ns > 0 for r in recs)
    own = self_ns(recs)
    kids = recs[1].end_ns - recs[1].start_ns + recs[2].end_ns - recs[2].start_ns
    assert own[0] == recs[0].end_ns - recs[0].start_ns - kids
    assert own[1] == recs[1].end_ns - recs[1].start_ns and own[3] > 0
    events = prof.events()
    ranges = {e.name: e.time_range for e in events
              if e.name in ("outer", "inner.mm", "inner.add", "second")}
    assert set(ranges) == {"outer", "inner.mm", "inner.add", "second"}
    mm = [e.time_range for e in events if e.name in ("aten::mm", "aten::matmul")]
    assert mm and all(ranges["inner.mm"].start <= r.start and r.end <= ranges["inner.mm"].end
                      for r in mm)
    inner = ranges["inner.mm"]
    assert ranges["outer"].start <= inner.start and inner.end <= ranges["outer"].end


def test_self_time_leaves_out_what_the_children_cover():
    recs = [SpanRecord(0, "root", 0, -1, 100, 200), SpanRecord(1, "a", 0, 0, 110, 140),
            SpanRecord(2, "b", 0, 1, 120, 130), SpanRecord(3, "c", 0, 0, 150, 190),
            SpanRecord(4, "open", 0, 0, 195)]
    assert self_ns(recs) == {0: 30, 1: 20, 2: 10, 3: 40}


def test_the_sync_counter_counts_the_warning_and_lets_others_through():
    filters = list(warnings.filters)
    shown = warnings.showwarning

    def work():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("default")
            with span("root") as root:
                with span("child") as child:
                    for _ in range(3):
                        warnings.warn(SYNC_MESSAGE + " (from a test)", UserWarning)
                    warnings.warn("another warning", RuntimeWarning)
                warnings.warn(SYNC_MESSAGE, UserWarning)
        return root, child, caught

    _, (root, child, caught) = _profiled(work)
    assert (child.syncs, root.syncs) == (3, 1)
    assert [str(w.message) for w in caught] == ["another warning"]
    assert warnings.filters == filters and warnings.showwarning is shown


def _race_trainer(seed=3, exact=True):
    return make_vision_race_trainer(num_envs=4, num_steps=4, seed=seed, frame_stack=2,
                                    n_obstacles=1, num_minibatches=2, update_epochs=2,
                                    rig=CameraRig(resolution=(16, 8)), rollout="kernel",
                                    kernel_exact_logprob=exact, device="cpu")


def _chase_trainer(seed=3, exact=False):
    return make_vision_trainer(num_envs=4, num_steps=4, seed=seed, num_minibatches=2,
                               update_epochs=2, rig=CameraRig(resolution=(16, 8)),
                               rollout="kernel", kernel_exact_logprob=exact, device="cpu")


@pytest.mark.parametrize("make,exact", [(_race_trainer, True), (_chase_trainer, False)],
                         ids=["k8_exact_logprob", "k7"])
def test_a_kernel_trainer_iteration_records_the_full_tree(make, exact):
    trainer = make(exact=exact)
    _profiled(lambda: trainer.train_iteration(trainer.state))
    recs = spans()
    (root,) = [r for r in recs if r.parent == -1]
    assert root.name == "ppo.iteration" and all(r.root == root.index for r in recs)
    top = [r.name for r in _children(recs, root)]
    assert top == ["ppo.rollout", "ppo.gae"] + (["ppo.shuffle"] + ["ppo.minibatch"] * 2) * 2 \
        + ["ppo.info"]
    minibatches = [r for r in _children(recs, root) if r.name == "ppo.minibatch"]
    for mb in minibatches:
        assert [r.name for r in _children(recs, mb)] == ["ppo.loss", "ppo.backward",
                                                         "ppo.clip", "ppo.adam"]
    (rollout,) = _children(recs, _children(recs, root)[0])
    assert rollout.name == "rollout"
    assert [r.name for r in _children(recs, rollout)] == (
        ["rollout.weights", "rollout.launch"] + ["rollout.logprob"] * exact + ["rollout.boot"])
    assert len(recs) == 1 + 1 + 1 + 1 + 2 + 4 * 5 + 1 + 3 + exact
    own = self_ns(recs)
    assert sum(own.values()) == root.end_ns - root.start_ns
    assert sum(r.syncs for r in recs) == 0  # no CUDA: the counter is not on


def test_the_recurrent_learner_records_the_same_names():
    trainer = make_vision_race_trainer(num_envs=4, num_steps=3, seed=1, num_minibatches=2,
                                       update_epochs=1, gru=8, rollout="scan",
                                       rig=CameraRig(resolution=(16, 8)), device="cpu")
    _profiled(lambda: trainer.train_iteration(trainer.state))
    recs = spans()
    (root,) = [r for r in recs if r.parent == -1]
    assert [r.name for r in _children(recs, root)] == [
        "ppo.rollout", "ppo.gae", "ppo.shuffle", "ppo.minibatch", "ppo.minibatch", "ppo.info"]
    assert sorted({r.name for r in recs if r.parent not in (-1, root.index)}) == [
        "ppo.adam", "ppo.backward", "ppo.clip", "ppo.loss"]


def test_the_train_loop_records_its_chunks_and_read_backs():
    _profiled(lambda: train_acro(num_envs=8, num_iterations=2, num_steps=4, scan_chunk=1,
                                 device="cpu"))
    recs = spans()
    roots = [r.name for r in recs if r.parent == -1]
    assert roots == ["train.chunk", "train.readback"] * 2
    iterations = [r for r in recs if r.name == "ppo.iteration"]
    assert len(iterations) == 2
    chunks = {r.index for r in recs if r.name == "train.chunk"}
    assert all(r.parent in chunks and r.root == r.parent for r in iterations)


def test_one_iteration_is_bit_identical_under_the_profiler():
    plain, traced = _race_trainer(), _race_trainer()
    st_a, info_a = plain.train_iteration(plain.state)
    _, (st_b, info_b) = _profiled(lambda: traced.train_iteration(traced.state))
    assert spans() and len(spans()) == len({r.index for r in spans()})
    for (k, a), (_, b) in zip(st_a.params.state_dict().items(),
                              st_b.params.state_dict().items()):
        assert torch.equal(a, b), k
    for k in info_a:
        assert torch.equal(info_a[k], info_b[k]), k
    assert torch.equal(st_a.env_state[0], st_b.env_state[0])


@pytest.mark.cuda
def test_cuda_the_sync_counter_counts_each_blocking_sync_once():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync counter reads torch.cuda's sync warnings")
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()

    def work():
        with span("root") as root:
            with span("items") as items:
                for _ in range(3):
                    (x * 2).sum().item()
            with span("copies") as copies:
                torch.tensor(2.0, device="cuda")
                torch.arange(4.0).to("cuda")
                x.cpu()
            with span("none") as none:
                y = x * 3
                y.add_(1)
        return root, items, copies, none

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        root, items, copies, none = work()
    assert (root.syncs, items.syncs, copies.syncs, none.syncs) == (0, 3, 3, 0)
    assert torch.cuda.get_sync_debug_mode() == mode
