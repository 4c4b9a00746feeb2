"""ctypes binding to the native Linux joystick adapter.

The winmm-binding analog (src/utils/joystickapi.py:40-74 joyGetNumDevs /
joyGetDevCaps / joyGetPosEx) for Linux: the C++ side
(native/joystick/fpyv_joystick.cpp) reads /dev/input/js* and this module
exposes it with the same flavor of thin, errno-returning calls. The port's
own copy of ``fpyv_tpu.inputs.joystick_native``; the library is built into
``build/native/`` (:mod:`fpyv_tpu_torch.inputs.build_native`).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from fpyv_tpu_torch.inputs.build_native import build_joystick_lib

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build_joystick_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.fj_num_devices.restype = ctypes.c_int
    lib.fj_open.argtypes = [ctypes.c_int]
    lib.fj_open.restype = ctypes.c_int
    lib.fj_close.argtypes = [ctypes.c_int]
    lib.fj_num_axes.argtypes = [ctypes.c_int]
    lib.fj_num_axes.restype = ctypes.c_int
    lib.fj_num_buttons.argtypes = [ctypes.c_int]
    lib.fj_num_buttons.restype = ctypes.c_int
    lib.fj_name.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.fj_name.restype = ctypes.c_int
    lib.fj_poll.argtypes = [ctypes.c_int]
    lib.fj_poll.restype = ctypes.c_int
    lib.fj_read_axes.argtypes = [ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.fj_read_axes.restype = ctypes.c_int
    lib.fj_read_buttons.argtypes = [ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
    lib.fj_read_buttons.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    lib = _load()
    return lib is not None and lib.fj_num_devices() > 0


def num_devices() -> int:
    lib = _load()
    return 0 if lib is None else int(lib.fj_num_devices())


class NativeJoystick:
    """One open /dev/input/js device."""

    def __init__(self, index: int = 0):
        lib = _load()
        if lib is None:
            raise OSError("native joystick adapter unavailable")
        handle = lib.fj_open(index)
        if handle < 0:
            raise OSError(f"cannot open joystick {index} (errno {-handle})")
        self._lib = lib
        self.handle = handle
        self.n_axes = int(lib.fj_num_axes(handle))
        self.n_buttons = int(lib.fj_num_buttons(handle))

    @property
    def name(self) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.fj_name(self.handle, buf, 256)
        return buf.value.decode(errors="replace") if n > 0 else ""

    def read(self) -> Tuple[np.ndarray, np.ndarray]:
        """Poll events, return (axes int32 [-32767, 32767], buttons int32)."""
        self._lib.fj_poll(self.handle)
        axes = (ctypes.c_int32 * max(self.n_axes, 1))()
        btns = (ctypes.c_int32 * max(self.n_buttons, 1))()
        self._lib.fj_read_axes(self.handle, axes, self.n_axes)
        self._lib.fj_read_buttons(self.handle, btns, self.n_buttons)
        return (np.ctypeslib.as_array(axes)[: self.n_axes].copy(),
                np.ctypeslib.as_array(btns)[: self.n_buttons].copy())

    def close(self) -> None:
        self._lib.fj_close(self.handle)
