"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
steady calls, held in memory and reduced to the device's busy time, each
kernel's device time and launches, and the idle gaps named by what the
host was doing in them: the innermost host op covering the gap's middle
and the op or call (the driver's ``record_function`` span) around it; a
gap inside a call with no op under way is Python of that call."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import torch


def _intervals(events, device: bool) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of the trace's device kernels and copies, or
    of its host ops, with no user annotation (a device-side range such as
    ``Optimizer.step#Adam.step`` would count its kernels twice)."""
    from torch.autograd import DeviceType

    out = []
    for ev in events:
        on_device = ev.device_type() == DeviceType.CUDA
        annotation = getattr(ev, "is_user_annotation", lambda: False)()
        if on_device != device or annotation and device:
            continue
        start = ev.start_ns()
        out.append((start, start + ev.duration_ns(), ev.name()))
    return out


def _union(iv: List[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e, _ in sorted(iv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def profile(fn: Callable[[], None], cuda: bool = True) -> Dict:
    """Run ``fn`` (which ends with the device idle) under the profiler.
    Returns window_s (host clock), busy_s (the union of device intervals),
    kernels {name: [device s, launches]}, device_ops and idle_gaps (the
    breakdown's lists, at most 10 each)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with tprofile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    dev = _intervals(events, device=True)
    host = _intervals(events, device=False)
    kernels: Dict[str, List[float]] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (e - s) * 1e-9
        k[1] += 1
    busy = _union(dev)
    longest = sorted(((b - a, a, b) for (_, a), (b, _) in zip(busy, busy[1:])), reverse=True)
    gaps = []
    for length, a, b in longest[:10]:
        mid = (a + b) // 2
        covering = sorted((s, name) for s, e, name in host if s <= mid <= e)
        what = " in ".join(name for _, name in covering[::-1][:2]) or "host outside the calls"
        gaps.append([what[:120], length * 1e-9])
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {"window_s": window_s, "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "kernels": kernels,
            "device_ops": [[name[:120], v[0]] for name, v in ranked[:10]],
            "idle_gaps": gaps}


def kernel_time(trace: Dict, fragment: str) -> Tuple[float, int]:
    """(device seconds, launches) of the kernels whose name holds
    ``fragment``."""
    s, n = 0.0, 0
    for name, (t, k) in trace.get("kernels", {}).items():
        if fragment in name:
            s, n = s + t, n + k
    return s, n
