"""The port's surface against the JAX package's: every module of
``fpyv_tpu`` has a module at the same path in ``fpyv_tpu_torch`` (the
Pallas kernel modules map to the CUDA kernels' modules, ``PALLAS``), every
public top-level name of each JAX module resolves in its counterpart and
every name an ``__init__`` of JAX's re-exports is re-exported by the
port's (exceptions listed in ``RENAMED``, ``TPU_ONLY`` and ``DROPPED``
with their reasons), and every module of the port imports. Read from the sources
with ``ast``: no JAX module is imported here.
"""

import ast
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "fpyv_tpu", ROOT / "fpyv_tpu_torch"

# the Pallas kernel modules and the modules of their CUDA kernels
PALLAS = {"ops/pallas_step.py": "ops/step_kernel.py", "ops/pallas_env.py": "ops/env_kernel.py",
          "ops/pallas_vision.py": "ops/vision_kernel.py",
          "ops/pallas_policy.py": "ops/policy_kernel.py",
          "ops/pallas_race.py": "ops/race_kernel.py"}
# a Pallas entry point and the port's name for the same function over the
# same state, which launches the CUDA kernel
RENAMED = {
    "ops/pallas_step.py": {"pallas_drone_step": "fused_drone_step",
                           "pallas_rollout": "fused_rollout"},
    "ops/pallas_env.py": {"pallas_env_rollout": "fused_env_rollout"},
    "ops/pallas_vision.py": {"pallas_render_depth": "fused_render_depth",
                             "pallas_vision_env_rollout": "fused_vision_env_rollout"},
    "ops/pallas_policy.py": {"pallas_policy_vision_rollout": "fused_policy_vision_rollout"},
    "ops/pallas_race.py": {"pallas_race_vision_rollout": "fused_race_vision_rollout"},
}
# the TPU's tile constants: the CUDA kernels lay out one env a thread (or
# four lanes an env), with no (8, N/8) sublane tiles
TPU_ONLY = {"ops/pallas_step.py": {"SUBLANES"}, "ops/pallas_vision.py": {"E_BLK"}}
# JAX names the port removed: a one-call steps/s meter that nothing of the
# port read (the trainers' ``Throughput`` and the benchmark time their rates)
DROPPED = {"utils/profiling.py": {"measure_steps_per_second"}}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def _bound_names(path: Path):
    """(names a module defines at top level, names it imports from its own
    package), both without a leading underscore."""
    defined, reexported = set(), set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] in (
                "fpyv_tpu", "fpyv_tpu_torch"):
            reexported |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            defined |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            defined.add(node.target.id)
    public = lambda names: {n for n in names if not n.startswith("_")}
    return public(defined), public(reexported)


def _port_module(rel: str) -> str:
    parts = ["fpyv_tpu_torch"] + PALLAS.get(rel, rel)[:-3].split("/")
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_has_its_port_module(rel):
    assert (PORT_PKG / PALLAS.get(rel, rel)).is_file(), rel


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_resolves(rel):
    """A JAX module's public names resolve in the port's module; an
    ``__init__``'s re-exports are re-exported by the port's ``__init__``
    itself (not merely reachable as a submodule someone else imported)."""
    defined, reexported = _bound_names(JAX_PKG / rel)
    module = importlib.import_module(_port_module(rel))
    renamed = RENAMED.get(rel, {})
    left_out = TPU_ONLY.get(rel, set()) | DROPPED.get(rel, set())
    missing = sorted(n for n in defined - left_out
                     if not hasattr(module, renamed.get(n, n)))
    if rel.endswith("__init__.py"):
        port_defined, port_reexported = _bound_names(PORT_PKG / rel)
        missing += sorted(n for n in reexported if n not in port_reexported | port_defined)
    assert not missing, f"{rel}: {missing}"


def test_the_tables_name_real_names():
    """Every exception names a name that the JAX module has and, where
    renamed, that the port's module has."""
    for rel, names in RENAMED.items():
        defined, _ = _bound_names(JAX_PKG / rel)
        module = importlib.import_module(_port_module(rel))
        for jax_name, port_name in names.items():
            assert jax_name in defined and callable(getattr(module, port_name)), jax_name
    for rel, names in TPU_ONLY.items():
        assert names <= _bound_names(JAX_PKG / rel)[0]
    for rel, names in DROPPED.items():
        assert names <= _bound_names(JAX_PKG / rel)[0]
        module = importlib.import_module(_port_module(rel))
        assert not any(hasattr(module, n) for n in names)


def test_every_port_module_imports_without_a_build_or_a_cycle():
    """Every module of the port imports with no process started (no nvcc
    build at import), and the entry modules of the package's import
    graph each import first in a fresh interpreter (an import cycle shows
    only from the right entry module); the interpreters run side by side."""
    names = sorted(m.name for m in pkgutil.walk_packages([str(PORT_PKG)], "fpyv_tpu_torch."))
    walk = ("import importlib, subprocess\n"
            "def refuse(*args, **kwargs):\n"
            "    raise RuntimeError(f'a process was started at import: {args}')\n"
            "subprocess.Popen = refuse\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n")
    firsts = ["fpyv_tpu_torch.sensors", "fpyv_tpu_torch.sensors.imu",
              "fpyv_tpu_torch.sensors.baro", "fpyv_tpu_torch.envs.sensor_acro",
              "fpyv_tpu_torch.envs", "fpyv_tpu_torch.control.flight_modes",
              "fpyv_tpu_torch.models.terrain", "fpyv_tpu_torch.utils.debug",
              "fpyv_tpu_torch.interop", "fpyv_tpu_torch.vision.geometry"]
    scripts = [walk] + [f"import {m}" for m in firsts]
    procs = [subprocess.Popen([sys.executable, "-c", c], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in scripts]
    for c, p in zip(scripts, procs):
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, (c[:80], err[-2000:])
