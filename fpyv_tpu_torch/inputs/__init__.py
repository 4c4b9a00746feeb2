"""RC transmitter / joystick input (the reference's L4 layer); the port's
own copy of ``fpyv_tpu.inputs``.

- :mod:`fpyv_tpu_torch.inputs.joystick_native` — ctypes binding to the
  native Linux joystick adapter (native/joystick/fpyv_joystick.cpp), the
  equivalent of the reference's winmm.dll binding (src/utils/joystickapi.py).
- :mod:`fpyv_tpu_torch.inputs.rc` — the Joystick class: discovery,
  normalized and calibrated reads, JSON calibration persistence (frsky.json
  schema parity), and the interactive calibration wizard. The calibration
  *transform* is also a batched tensor function (``calib_transform``).
- :mod:`fpyv_tpu_torch.inputs.ports` — serial-port picker (the tkinter
  PortSelector's non-GUI equivalent).
- :mod:`fpyv_tpu_torch.inputs.mouse` — the mouse-drag virtual target.

All hardware paths degrade gracefully when no device exists (the reference's
"Joystick device was not found" + random-goal fallback, rotation_pid.py:58-63).
"""

from fpyv_tpu_torch.inputs.rc import Joystick, calib_transform  # noqa: F401
