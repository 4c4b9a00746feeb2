"""The benchmark's files, its lookups by name and its rules, on the CPU."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run as prun

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CHECKS = {"rollout": {"start", "frames", "ends", "env", "boot", "boot_env", "mean", "value",
                      "log_prob"}}
CHECKS["train"] = CHECKS["rollout"] | {"loss", "grad", "change"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    found = prun.find_cell(BENCH, cell)
    for fn in ("setup", "window", "check"):
        assert callable(getattr(found["driver"], fn))
    assert found["cfg"]["name"] == found["cell"]["config"]
    assert found["wl"]["name"] == cell
    assert set(found["wl"]["limits"]) == CHECKS[found["wl"]["driver"]]
    for m in found["end_to_end"] + found["per_layer"]:
        assert callable(prun.load_file(prun.HERE / "metrics" / f"{m['name']}.py").read)
    if found["wl"].get("policy"):
        assert (REPO / found["wl"]["policy"]).exists()


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in BENCH["paths"]:
        assert (REPO / p).is_dir() and not p.endswith("_torch")
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (REPO / c["file"]).exists() and c["source"].startswith("https://")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        names.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
        reported = [m["name"] for m in BENCH["end_to_end"] if prun._applies(m, w["name"])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(prun._applies(m, w["name"]) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", CELLS):
            assert prun._applies(e2e[m["moves"]], cell)


def test_a_new_cell_is_picked_up_from_its_own_file(tmp_path):
    wl = json.loads((prun.HERE / "workloads" / "chase_rollout.json").read_text())
    wl.update(name="chase_rollout_again", traffic="rollout_loop_again")
    (tmp_path / "chase_rollout_again.json").write_text(json.dumps(wl))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "chase_rollout_again", "config": "chase_k7",
                               "traffic": "rollout_loop_again", "chips": 1, "why": "test"})
    found = prun.find_cell(bench, "chase_rollout_again", workloads=tmp_path)
    assert found["wl"]["name"] == "chase_rollout_again"
    assert [m["name"] for m in found["end_to_end"]] == ["setup_s"]


def test_a_new_metric_is_read_from_its_own_file(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "calls.twice.py").write_text(
        "def read(ctx):\n    return 2 * ctx['calls']\n")
    (tmp_path / "metrics" / "silent.py").write_text("def read(ctx):\n    return None\n")
    out = prun.read_metrics([{"name": "calls.twice", "unit": "1"}, {"name": "silent", "unit": "%"}],
                            {"calls": 21}, tmp_path)
    assert out == {"calls.twice": {"value": 42.0, "unit": "1"}}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for path in (prun.HERE / "reference").glob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in prun.FORBIDDEN + ("fpyv_tpu_torch",), (path, mod)


def test_what_a_run_loads_holds_no_jax():
    files = [str(p) for p in sorted((prun.HERE / "drivers").glob("*.py"))
             + sorted((prun.HERE / "metrics").glob("*.py"))]
    code = ("import json, sys\n"
            "import portbench.run as r, portbench.calibrate, fpyv_tpu_torch.apps.train\n"
            "from pathlib import Path\n"
            f"[r.load_file(Path(f)) for f in {files!r}]\n"
            "print(json.dumps(r.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_run_without_a_card_prints_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                              "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(prun.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "2", "--trace", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0, res
