"""The program's own spans (``fpyv_tpu_torch.utils.profiling.span``) of a
``--trace 1`` run, for the metrics that read them: the records that the
traced steady calls left under ``torch.profiler``, grouped by their root
span (one iteration or one rollout call). The spans are recorded only
while the profiler runs, so the buffer holds the traced calls alone. A
program that records no spans, or no root of the asked name, gives None."""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional


def roots(ctx: Dict, name: str) -> Optional[Dict[int, list]]:
    """{root index: its closed records, the root's first} of the traced
    calls whose root span is ``name``; None where the run was not traced or
    the program left no such root."""
    if not ctx.get("trace"):
        return None
    from fpyv_tpu_torch.utils import profiling

    records = getattr(profiling, "spans", lambda: [])()
    wanted = {r.index for r in records if r.parent == -1 and r.name == name and r.end_ns}
    out: Dict[int, list] = {}
    for r in records:
        if r.root in wanted and r.end_ns:
            out.setdefault(r.root, []).append(r)
    return out or None


def ms(records: List, *names: str) -> float:
    """Summed host ms of the records named ``names``."""
    return sum(r.end_ns - r.start_ns for r in records if r.name in names) * 1e-6


def syncs(records: List) -> int:
    return sum(r.syncs for r in records)


def report(metric: str, groups: Dict[int, list]) -> None:
    """The sample count and each span name's calls, self ms and syncs a
    root, to standard error."""
    from fpyv_tpu_torch.utils.profiling import self_ns

    n = len(groups)
    rows: Dict[str, List[float]] = {}
    for recs in groups.values():
        own = self_ns(recs)
        for r in recs:
            row = rows.setdefault(r.name, [0, 0.0, 0])
            row[0] += 1
            row[1] += own[r.index] * 1e-6
            row[2] += r.syncs
    print(f"{metric} over {n} roots; span: calls, self ms a root, syncs a root",
          file=sys.stderr)
    for name, (calls, self_ms, sync) in rows.items():
        print(f"  {name:<16} {calls:5d} {self_ms / n:10.3f} {sync / n:7.2f}", file=sys.stderr)


def median_of(metric: str, groups: Optional[Dict[int, list]], per_root) -> Optional[float]:
    """The median over roots of ``per_root(records)``, the table printed."""
    if not groups:
        return None
    report(metric, groups)
    return statistics.median(per_root(recs) for recs in groups.values())


def mean_of(metric: str, groups: Optional[Dict[int, list]], per_root) -> Optional[float]:
    """The mean over roots of ``per_root(records)``, the table printed."""
    if not groups:
        return None
    report(metric, groups)
    return statistics.fmean(per_root(recs) for recs in groups.values())
