"""Build and load the port's CUDA kernels (``fpyv_tpu_torch/csrc``).

At first use, each ``*.cu`` source is compiled by its own ``nvcc`` process,
all started together, for ``sm_90a``; the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds. The library lands in
``build/kernels/`` at the repository root (git-ignored), named by a hash of
the sources and flags, so an unchanged tree reuses it.

Math flags: no ``--use_fast_math`` (``sinf``/``cosf``/``logf``/``sqrtf`` and
division stay IEEE-accurate) and ``--fmad=false`` (no multiply-add
contraction), so a kernel and its plain PyTorch version round alike and
differ by libm ulps at most.

Each kernel wrapper counts its launches in :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("step_kernels.cu", "env_kernels.cu", "vision_kernels.cu", "policy_kernels.cu",
           "race_kernels.cu", "levels_kernels.cu")
HEADERS = ("physics.cuh", "env.cuh", "lanes.cuh", "render.cuh", "actor.cuh", "clock.cuh")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xptxas=-v",
              "-Xcompiler", "-fPIC")

# kernel name -> launches since the last reset_launch_counts()
launch_counts: Dict[str, int] = {"drone_step": 0, "rollout": 0, "env_rollout": 0,
                                  "render_depth": 0, "vision_env_rollout": 0,
                                  "policy_vision_rollout": 0, "race_vision_rollout": 0,
                                  "levels_lut": 0}

_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this tree's library is not built yet; returns
    its path. ``build_info`` records the seconds spent and ptxas' report."""
    lib_path = BUILD_DIR / f"libfpyv_kernels_{_digest()}.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, ARCH, "-shared", *(str(o) for _, o, _ in procs),
                           "-o", str(tmp)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "\n".join(logs)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.fpyv_drone_step.argtypes = [P, I, P, P, P, I, P, I, P, I, P]
        lib.fpyv_rollout.argtypes = [P, I, P, P, P, I, P, I, P, I, I, P]
        lib.fpyv_rollout_lanes.argtypes = [P, I, I, I, I]
        lib.fpyv_env_rollout_lanes.argtypes = [P, I, I, I, I]
        lib.fpyv_env_rollout.argtypes = [P, I, P, I, I, P, P, P, I, P, I, P, P, I, I,
                                         I, I, P, P]
        lib.fpyv_render_depth.argtypes = [P, I, P, I, P, P, I, I, P, I, P]
        lib.fpyv_vision_env_rollout.argtypes = [P, I, P, I, P, I, I, P, P, I, P, I, P, I, I,
                                                P, P, P, P, I, I, I, I, P, P]
        lib.fpyv_policy_vision_rollout.argtypes = [P, I, P, I, P, I, I, P, P, I, P, I, P, P, P,
                                                   P, P, P, I, P, I, P, P, P, I, I, P, P, P, P,
                                                   I, I, P, P]
        lib.fpyv_race_vision_rollout.argtypes = [P, I, P, I, P, I, I, I, P, P, P, P, P, I, P, P,
                                                 P, P, P, P, I, P, I, P, P, P, I, I, P, P, P, P, I,
                                                 I, P, P]
        lib.fpyv_levels_lut.argtypes = [P, P, P, ctypes.c_longlong, I, P]
        for fn in (lib.fpyv_drone_step, lib.fpyv_rollout, lib.fpyv_rollout_lanes,
                   lib.fpyv_env_rollout, lib.fpyv_env_rollout_lanes,
                   lib.fpyv_render_depth, lib.fpyv_vision_env_rollout,
                   lib.fpyv_policy_vision_rollout, lib.fpyv_race_vision_rollout,
                   lib.fpyv_levels_lut):
            fn.restype = I
        lib.fpyv_error_string.argtypes = [I]
        lib.fpyv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned right after a launch."""
    if err != 0:
        msg = library().fpyv_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err}: {msg}")
