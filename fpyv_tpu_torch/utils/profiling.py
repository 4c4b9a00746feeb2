"""Timing helpers (the port's own copy of ``fpyv_tpu.utils.profiling``):
a mean +- std timer and an env-steps/s throughput meter.

Both read the host clock. A CUDA call returns before the device finishes,
so a measured region ends in a device synchronisation or a device-to-host
read.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

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
