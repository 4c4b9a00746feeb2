"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in BENCHMARK.json) names its
configuration (``portbench/configs/<config>.json``); its own file
``portbench/workloads/<cell>.json`` names the driver
(``portbench/drivers/<driver>.py``), the traffic's parameters and the
limits of the correctness check; each metric is read by
``portbench/metrics/<metric>.py``. A run builds the system under test from
``--seed``, warms it (set-up), drives the driver's timed entry for
``--seconds`` without adding a synchronize, ends the window with
``torch.cuda.synchronize()``, reads the memory peak, frees the program's
state and checks what the timed path produced against the plain reference
in ``portbench/reference``. It prints each compared number beside its limit
as the last lines of standard error, and one JSON line last on standard
output: the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics and the trace's breakdown (``--trace 1``). ``attempted`` counts the
window's calls, ``failed`` the checked calls with a number over its limit.

It exits non-zero without a result where CUDA is absent or has fewer
cards than the cell asks for, and where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fpyv_tpu")
# the host runs the program's Python with one intra-op thread: the cells are
# host-paced, and a pool of threads on a shared host spreads set-up and runs
HOST_THREADS = 1


def load_file(path: Path):
    """A module from a file of the benchmark, by path (names may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_file_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _applies(entry: Dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def find_cell(bench: Dict, name: str, root: Path = HERE, repo: Path = REPO,
              workloads: Optional[Path] = None) -> Dict:
    """Everything a run of cell ``name`` needs, found by name: the cell,
    its configuration, its workload file (in ``workloads``, by default
    the benchmark's own folder), its driver and its metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((repo / conf["file"]).read_text())
    wl = json.loads(((workloads or root / "workloads") / f"{name}.json").read_text())
    if wl["traffic"] != cell["traffic"]:
        raise ValueError(f"{name}: workload file's traffic {wl['traffic']!r} is not the cell's "
                         f"{cell['traffic']!r}")
    return {"cell": cell, "cfg": cfg, "wl": wl,
            "driver": load_file(root / "drivers" / f"{wl['driver']}.py"),
            "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
            "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
            "root": root}


def read_metrics(entries, ctx: Dict, root: Path) -> Dict:
    out = {}
    for m in entries:
        v = load_file(root / "metrics" / f"{m['name']}.py").read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_note() -> str:
    """The card's name and power limit (nvidia-smi), for the log."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def run_cell(found: Dict, seed: int, seconds: float, trace: bool, device,
             start: Optional[float] = None) -> Dict:
    """One run of a found cell on ``device``: the result dict (``checks``
    holds each compared number and its limit)."""
    import torch

    cfg, wl, driver = found["cfg"], dict(found["wl"]), found["driver"]
    if wl.get("policy"):
        wl["policy"] = str(REPO / wl["policy"])
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(HOST_THREADS)
    s = driver.setup(cfg, wl, seed, device)
    s["cfg"] = cfg
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - (START if start is None else start)
    ctx = driver.window(s, wl, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for k in ("trainer", "state"):
        s.pop(k, None)
    if cuda:
        torch.cuda.empty_cache()
    rows = []
    numbers = driver.check(cfg, s, per_launch=rows)
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    # a checked call fails where any of its numbers is over its limit (or not a number)
    failed = sum(any(not (v <= limits[k]) for k, v in row.items()) for row in rows)
    ends = sum(float((L.done > 0.5).sum()) for L in s["launches"]) / len(s["launches"])
    ctx.update({"cfg": cfg, "setup_s": setup_s, "ends_per_launch": ends})
    result = {"correct": not failed, "attempted": ctx["calls"], "failed": failed,
              "metrics": read_metrics(found["per_layer"] if trace else found["end_to_end"], ctx,
                                      found["root"]),
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                         "count": found["cell"]["chips"], "memory_peak_bytes": int(peak)}}
    if trace and ctx.get("trace"):
        tr = ctx["trace"]
        result["device"].update({"busy_s": tr["busy_s"], "window_s": tr["window_s"]})
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's build and kernel caches stay inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    found = find_cell(bench, args.workload)
    import torch

    chips = found["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(found, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package is loaded: {loaded}", file=sys.stderr)
        return 4
    print(f"card: {card_note()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
