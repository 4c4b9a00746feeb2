"""Timing and tracing helpers (mirrors ``fpyv_tpu.utils.profiling``): a
mean +- std timer, an env-steps/s throughput meter, a ``torch.profiler``
trace context, and the program's spans with their sync counts.

The timers read the host clock. A CUDA call returns before the device finishes,
so a measured region ends in a device synchronisation or a device-to-host
read.

Spans (:func:`span`) record only while ``torch.profiler`` is
running; otherwise a span is one read of the profiler's flag. Under the
profiler each span is a ``record_function`` range, on the trace's own
timeline and clock beside the CUDA runtime calls and the device's kernels,
and a :class:`SpanRecord` in a bounded in-memory buffer (:func:`spans`,
:func:`clear_spans`, :func:`self_ns`) that also counts the blocking
host-device synchronisations made inside it.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch


def timeit(func: Callable, n: int = 100, block: bool = True):
    """Wrap ``func`` to time n calls, mean +- std seconds. ``block=True``
    synchronises the CUDA device after each call so queued work counts."""

    def wrapper(*args, **kwargs):
        times = np.zeros(n)
        out = None
        for i in range(n):
            start = time.perf_counter()
            out = func(*args, **kwargs)
            if block and torch.cuda.is_available():
                torch.cuda.synchronize()
            times[i] = time.perf_counter() - start
        print(f"Average time: {times.mean()} ± {times.std()}")
        return out, (times.mean(), times.std())

    return wrapper


@dataclass
class Throughput:
    """Running env-steps/s meter."""

    unit: str = "env-steps"
    _t0: float = field(default_factory=time.perf_counter)
    _count: float = 0.0

    def add(self, n: float) -> None:
        self._count += n

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._count / dt if dt > 0 else 0.0

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._count = 0.0

    def report(self) -> str:
        return f"{self.rate():,.0f} {self.unit}/s"


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace of the block (the host and, where there is
    one, the CUDA device), written under ``log_dir`` as a TensorBoard trace
    file when the block ends; nothing when ``log_dir`` is None. The
    program's spans (:func:`span`) appear in it as named ranges around the
    ops they cover, and their records, sync counts included, are left in
    :func:`spans`."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

MAX_SPANS = 65536  # records kept; the oldest go first
SYNC_MESSAGE = "called a synchronizing CUDA operation"  # torch.cuda's sync debug warning

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


@dataclass
class SpanRecord:
    """One span: ``index`` counts the records made since the last
    :func:`clear_spans`; ``root`` is the index of the outermost span of the
    same top-level call (its own for a root), ``parent`` the enclosing
    span's (-1 for a root); host times from ``time.perf_counter_ns``
    (``end_ns`` 0 while open); ``syncs`` the blocking synchronisations
    counted while it was the innermost open span."""

    index: int
    name: str
    root: int
    parent: int
    start_ns: int
    end_ns: int = 0
    syncs: int = 0


class _Recorder:
    """The process's span buffer, the stack of open spans, and the sync
    counter, installed while a root span is open. The profiler's state is
    the thread's own, so spans open in the thread that runs it."""

    def __init__(self):
        self.records: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.count = 0
        self.stack: List[SpanRecord] = []
        self.catcher: Optional[warnings.catch_warnings] = None
        self.sync_mode: Optional[int] = None

    def open(self, name: str) -> SpanRecord:
        top = self.stack[-1] if self.stack else None
        if top is None:
            self._count_syncs()
        rec = SpanRecord(self.count, name, top.root if top else self.count,
                         top.index if top else -1, time.perf_counter_ns())
        self.count += 1
        self.records.append(rec)
        self.stack.append(rec)
        return rec

    def close(self, rec: SpanRecord) -> None:
        rec.end_ns = time.perf_counter_ns()
        self.stack.pop()
        if not self.stack:
            self._stop_counting()

    def _count_syncs(self) -> None:
        """Catch torch.cuda's sync debug warning (each occurrence: filter
        "always") and let every other warning through; on a process that
        uses CUDA, turn that warning on."""
        self.catcher = warnings.catch_warnings()
        self.catcher.__enter__()
        passed_on = warnings.showwarning
        warnings.filterwarnings("always", message=SYNC_MESSAGE)

        def show(message, category, filename, lineno, file=None, line=None):
            if self.stack and str(message).startswith(SYNC_MESSAGE):
                self.stack[-1].syncs += 1
            else:
                passed_on(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        if torch.cuda.is_initialized():
            self.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def _stop_counting(self) -> None:
        if self.sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self.sync_mode)
            self.sync_mode = None
        self.catcher.__exit__(None, None, None)
        self.catcher = None


_RECORDER = _Recorder()


class _Span:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.rec = _RECORDER.open(self.name)
        return self.rec

    def __exit__(self, *exc):
        _RECORDER.close(self.rec)
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one phase of the program. With no
    ``torch.profiler`` running it is a shared null context (no
    allocation, no clock read). Under one it opens a ``record_function``
    range called ``name`` and appends a :class:`SpanRecord`; while a root
    span (one opened with no other open) is open, each blocking CUDA
    synchronisation (``.item()``, ``.cpu()``, a copy with
    ``non_blocking=False``; torch.cuda's sync debug warning) adds one to
    the innermost open span's ``syncs``."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


def spans() -> List[SpanRecord]:
    """The recorded spans, oldest first (at most :data:`MAX_SPANS`)."""
    return list(_RECORDER.records)


def clear_spans() -> None:
    """Empty the buffer and restart the record indices at 0 (between
    calls, with no span open)."""
    _RECORDER.records.clear()
    _RECORDER.count = 0


def self_ns(records: Iterable[SpanRecord]) -> Dict[int, int]:
    """Each closed record's self time by index: its duration less the parts
    of it that its children cover (children of one span run one after
    another on its thread)."""
    closed = [r for r in records if r.end_ns]
    out = {r.index: r.end_ns - r.start_ns for r in closed}
    for r in closed:
        if r.parent in out:
            out[r.parent] -= r.end_ns - r.start_ns
    return out
