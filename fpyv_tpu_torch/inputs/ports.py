"""Serial-port picker for hardware-in-the-loop experiments.

The reference's PortSelector (src/utils/port_selector.py) is a tkinter
listbox over pyserial's port list. Headless environments are the norm here,
so the default is a CLI picker; both pyserial and tkinter are optional.

The port's own copy of ``fpyv_tpu.inputs.ports``.
"""

from __future__ import annotations

from typing import List, Optional


def list_ports() -> List[str]:
    try:
        from serial.tools import list_ports as lp  # type: ignore
    except ImportError:
        return []
    return [p.device for p in lp.comports()]


def select_port(interactive: bool = True) -> Optional[str]:
    """Pick a serial port: returns the single port if unambiguous, prompts
    on a TTY otherwise (the PortSelector dialog's non-GUI analog)."""
    ports = list_ports()
    if not ports:
        return None
    if len(ports) == 1 or not interactive:
        return ports[0]
    for i, p in enumerate(ports):
        print(f"[{i}] {p}")
    try:
        choice = input("Select port index: ")
        return ports[int(choice)]
    except (ValueError, IndexError, EOFError):
        return None
