"""ctypes wrapper over the native Betaflight blackbox decoder.

The reference parses .BBL logs via the optional ``orangebox`` Python package
(src/utils/log_reader.py:6-20). This wraps the from-scratch C++ decoder at
native/blackbox/fpyv_blackbox.cpp (headers, I/P/S frames, events, multi-log
files) built on demand with g++ into ``build/native/`` — no external
dependency. The port's own copy of ``fpyv_tpu.io.blackbox_native``.

Public API:
    decode_blackbox(path, log_index=0) -> {field_name: np.ndarray[int64]}
    num_logs(path) -> int
    header_value(path, key) -> str | None
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from fpyv_tpu_torch.inputs.build_native import NATIVE_SRC, build_shared_lib

_lib: Optional[ctypes.CDLL] = None


def build_blackbox_lib(force: bool = False) -> Optional[Path]:
    """Compile the decoder with g++ into ``build/native/`` if needed.
    Returns the .so path, or None when the toolchain is unavailable."""
    return build_shared_lib(NATIVE_SRC / "blackbox" / "fpyv_blackbox.cpp", force)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_blackbox_lib()
    if path is None:
        raise RuntimeError(
            "could not build the native blackbox decoder (g++ unavailable?)")
    lib = ctypes.CDLL(str(path))
    lib.bbx_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.bbx_open.restype = ctypes.c_int
    lib.bbx_num_logs.argtypes = [ctypes.c_int]
    lib.bbx_num_logs.restype = ctypes.c_int
    lib.bbx_num_fields.argtypes = [ctypes.c_int]
    lib.bbx_num_fields.restype = ctypes.c_int
    lib.bbx_field_name.argtypes = [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.bbx_field_name.restype = ctypes.c_int
    lib.bbx_num_frames.argtypes = [ctypes.c_int]
    lib.bbx_num_frames.restype = ctypes.c_longlong
    lib.bbx_read_frames.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_longlong),
                                    ctypes.c_longlong]
    lib.bbx_read_frames.restype = ctypes.c_longlong
    lib.bbx_header_value.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                     ctypes.c_char_p, ctypes.c_int]
    lib.bbx_header_value.restype = ctypes.c_int
    lib.bbx_error.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.bbx_error.restype = ctypes.c_int
    lib.bbx_close.argtypes = [ctypes.c_int]
    lib.bbx_close.restype = None
    _lib = lib
    return lib


class _Handle:
    def __init__(self, path, log_index: int):
        self.lib = _load()
        self.h = self.lib.bbx_open(str(path).encode(), int(log_index))
        if self.h < 0:
            raise ValueError(
                f"failed to open blackbox log {path!r} (log {log_index}): "
                f"code {self.h}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.lib.bbx_close(self.h)


def decode_blackbox(path, log_index: int = 0) -> Dict[str, np.ndarray]:
    """Decode one log of a .BBL file to {field_name: int64 array}.

    Columns are the main-frame fields followed by the slow-frame fields
    (slow values carried forward into each main row, like blackbox_decode).
    """
    with _Handle(path, log_index) as hd:
        lib, h = hd.lib, hd.h
        n_fields = lib.bbx_num_fields(h)
        n_frames = lib.bbx_num_frames(h)
        names = []
        buf = ctypes.create_string_buffer(256)
        for i in range(n_fields):
            if lib.bbx_field_name(h, i, buf, 256) < 0:
                raise RuntimeError(f"field {i} name lookup failed")
            names.append(buf.value.decode())
        data = np.zeros((max(n_frames, 1), n_fields), np.int64)
        if n_frames > 0:
            got = lib.bbx_read_frames(
                h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                n_frames)
            if got != n_frames:
                raise RuntimeError(f"read {got}/{n_frames} frames")
        err = ctypes.create_string_buffer(512)
        if lib.bbx_error(h, err, 512) > 0:
            raise ValueError(f"decode error: {err.value.decode()}")
        data = data[:n_frames]
        return {name: data[:, i].copy() for i, name in enumerate(names)}


def num_logs(path) -> int:
    """Number of concatenated logs in the file."""
    with _Handle(path, 0) as hd:
        return hd.lib.bbx_num_logs(hd.h)


def header_value(path, key: str, log_index: int = 0) -> Optional[str]:
    """A raw header value ('Firmware revision', 'minthrottle', ...)."""
    with _Handle(path, log_index) as hd:
        buf = ctypes.create_string_buffer(1024)
        n = hd.lib.bbx_header_value(hd.h, key.encode(), buf, 1024)
        return buf.value.decode() if n >= 0 else None
