"""Timing and tracing helpers (mirrors ``fpyv_tpu.utils.profiling``): a
mean +- std timer, an env-steps/s throughput meter, a ``torch.profiler``
trace context and a steps/s measurement of a step function.

The timers read the host clock. A CUDA call returns before the device finishes,
so a measured region ends in a device synchronisation or a device-to-host
read.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

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
    file when the block ends; nothing when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def measure_steps_per_second(step_fn: Callable, state, n_steps: int, batch: int,
                             warmup: bool = True) -> Tuple[float, object]:
    """Time one call of ``step_fn(state)`` that advances ``n_steps`` steps
    of ``batch`` envs, after a warm-up call: (env-steps/s, final state).
    The CUDA device is synchronised where JAX blocks on the result."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    if warmup:
        state = step_fn(state)
        sync()
    t0 = time.perf_counter()
    state = step_fn(state)
    sync()
    return n_steps * batch / (time.perf_counter() - t0), state
