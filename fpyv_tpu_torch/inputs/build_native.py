"""On-demand g++ builds of the native adapters (``native/*/*.cpp``); the
port's own copy of ``fpyv_tpu.inputs.build_native``.

The JAX package builds each library beside its source in ``native/``. The
port builds the same sources into ``build/native/`` at the repository root
(git-ignored, beside ``build/kernels/``), so both packages can build and
load at once in one test run. A build writes a temporary file and renames
it into place, so a concurrent reader sees the old library or the whole new
one, never half a file.
"""

from __future__ import annotations

import os
import subprocess
import uuid
from pathlib import Path
from typing import Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = REPO_ROOT / "native"
BUILD_DIR = REPO_ROOT / "build" / "native"


def build_shared_lib(src: Path, force: bool = False) -> Optional[Path]:
    """Compile ``src`` into ``build/native/lib<stem>.so`` with g++ unless a
    library newer than the source is there. Returns its path, or None when
    the toolchain is unavailable (callers degrade to no device)."""
    lib = BUILD_DIR / f"lib{src.stem}.so"
    if lib.exists() and not force and lib.stat().st_mtime >= src.stat().st_mtime:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(src), "-o", str(tmp)],
                       check=True, capture_output=True, text=True, timeout=120)
        os.replace(tmp, lib)
        return lib
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return None
    finally:
        tmp.unlink(missing_ok=True)


def build_joystick_lib(force: bool = False) -> Optional[Path]:
    """The joystick adapter (``native/joystick/fpyv_joystick.cpp``)."""
    return build_shared_lib(NATIVE_SRC / "joystick" / "fpyv_joystick.cpp", force)
