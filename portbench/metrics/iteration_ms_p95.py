"""iteration_ms_p95: the 95th percentile of the window's iteration times,
each between CUDA events recorded at the iteration's boundaries (no
synchronize added); the sample count goes to standard error."""

import statistics
import sys


def read(ctx):
    ms = ctx.get("iteration_ms") or []
    if ctx["kind"] != "train" or len(ms) < 20:
        return None
    q = statistics.quantiles(ms, n=4)
    print(f"iteration_ms_p95 over {len(ms)} iterations (quartiles {q[0]:.3f} {q[1]:.3f} "
          f"{q[2]:.3f} ms)", file=sys.stderr)
    return statistics.quantiles(ms, n=20, method="inclusive")[-1]
