"""The readings that a cell's correctness limits are set from, many seeds
in one process: for each seed a run's set-up, a short window at the cell's
own load, and the check of the program against the reference (the lower
readings); with ``--control 1`` also the control, the reference in float8
put in the program's place, read against the float32 reference, and with
``--faults <name> ...`` the program run with each fault planted in turn
(portbench/faults.py): the upper readings. Not part of a benchmark run.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 --seconds 2 --control 1
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench import faults
from portbench import run as prun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(faults.KERNEL) + list(faults.LEARNER))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(prun.HOST_THREADS)
    bench = json.loads((prun.REPO / "BENCHMARK.json").read_text())
    found = prun.find_cell(bench, args.workload)
    cfg, wl, driver = found["cfg"], dict(found["wl"]), found["driver"]
    if wl.get("policy"):
        wl["policy"] = str(prun.REPO / wl["policy"])
    for fault, seed in [(f, n) for f in args.faults or [None] for n in args.seeds]:
        t0 = time.perf_counter()
        with faults.planted(cfg, fault) if fault else contextlib.nullcontext():
            s = driver.setup(cfg, wl, seed, "cuda")
            s["cfg"] = cfg
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            ctx = driver.window(s, wl, args.seconds, False)
        for k in ("trainer", "state"):
            s.pop(k, None)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        detail = {}
        row = {"seed": seed, "fault": fault, "setup_s": setup_s, "calls": ctx["calls"],
               "program": driver.check(cfg, s, detail=detail), "leaves": detail}
        row["check_s"] = time.perf_counter() - t1
        if args.control and not fault:
            row["control"] = driver.check(cfg, s, control=True)
        print(json.dumps(row), flush=True)
        del s, ctx
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
