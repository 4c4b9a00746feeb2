"""RC transmitter input: discovery, calibrated reads, calibration wizard.

Reference parity (src/utils/get_sticks.py ``Joystick``):

- discovery + status flag; graceful "device not found" (no exception — the
  reference raises, but every call site immediately branches on a status
  flag, rotation_pid.py:16-20, so here status=False is the no-device path);
- ``read``: 6 raw axis values (:55-60 reads winmm's X,Y,Z,R,U,V; here the
  first 6 axes of the native Linux adapter, shifted from int16 to the
  reference's unsigned range so min/max calibration files transfer);
- ``norm_read`` (:250-252): per-axis min/max map to [-1, 1];
- ``calib_read`` (:254-265): apply sign_reverse then re-map each stick
  piecewise around its calibrated center ([-1,center]->[-1,0],
  [center,1]->[0,1]);
- ``calibrate`` (:101-223): load the JSON (frsky.json schema) or run the
  interactive wizard — detect active axes by variance, record min/max,
  identify each stick by "move it up/right", detect sign, find centers by
  settling, identify switches and their direction;
- ``read_sticks`` ordering (components.py:250-253): calibrated vector is
  [throttle, roll, pitch, aux1, aux2, yaw] -> action
  [-roll, pitch, yaw, throttle].

``calib_transform`` is the batched tensor version of calib_read (the port
of ``fpyv_tpu.inputs.rc.calib_transform``, the only JAX of ``inputs/``), for
recorded stick logs on any device; ``calib_read`` runs it on the one reading.
The rest is the port's own copy of ``fpyv_tpu.inputs.rc``.
"""

from __future__ import annotations

import os
from time import sleep
from typing import Dict, Optional

import numpy as np
import torch

from fpyv_tpu_torch.io.files import json_reader, json_writer

try:  # hardware path is optional
    from fpyv_tpu_torch.inputs.joystick_native import NativeJoystick, num_devices
except Exception:  # pragma: no cover - adapter build failure
    NativeJoystick = None  # type: ignore

    def num_devices() -> int:
        return 0


def map_from_to(x, a, b, c, d):
    """Linear range map (get_sticks.py:245-248)."""
    return (x - a) / (b - a) * (d - c) + c


def calib_transform(raw, min_vals, max_vals, sign_reverse, stick_idx,
                    stick_center):
    """Batched calibration: raw (..., 6) -> calibrated (..., 6) tensor on
    raw's device (numpy inputs are accepted; integer raws become the default
    float dtype).

    stick_idx: (4,) int indices of Throttle/Roll/Pitch/Yaw channels;
    stick_center: (4,) their centers. Each stick's channel maps piecewise
    around its center, ``where(v <= c, low, high)``.
    """
    raw = torch.as_tensor(raw)
    if not raw.is_floating_point():
        raw = raw.to(torch.get_default_dtype())
    kw = dict(dtype=raw.dtype, device=raw.device)
    norm = map_from_to(raw, torch.as_tensor(min_vals, **kw), torch.as_tensor(max_vals, **kw),
                       -1.0, 1.0) * torch.as_tensor(sign_reverse, **kw)
    out = norm.clone()
    for idx, c in zip(stick_idx, stick_center):
        idx, c = int(idx), float(c)
        v = norm[..., idx]
        low = map_from_to(v, -1.0, c, -1.0, 0.0)
        high = map_from_to(v, c, 1.0, 0.0, 1.0)
        out[..., idx] = torch.where(v <= c, low, high)
    return out


class Joystick:
    """RC transmitter over the native Linux adapter."""

    N_CHANNELS = 6  # the reference reads exactly 6 winmm axes

    def __init__(self, index: int = 0):
        self.device = None
        self.ret = False
        if NativeJoystick is not None and num_devices() > index:
            try:
                self.device = NativeJoystick(index)
                self.ret = True
                print(f"gamepad detected: {self.device.name}")
            except OSError:
                self.device = None
        self.calib = False
        self.min_vals = np.zeros(self.N_CHANNELS)
        self.max_vals = np.full(self.N_CHANNELS, 65535.0)
        self.sign_reverse = np.ones(self.N_CHANNELS)
        self.sticks: Dict = {}
        self.switches: Dict = {}
        self.calib_reading = np.zeros(self.N_CHANNELS)
        self.last_raw = np.zeros(self.N_CHANNELS)

    @property
    def status(self) -> bool:
        return self.ret

    # ---- raw reads --------------------------------------------------------

    def read(self) -> np.ndarray:
        """(1, 6) raw axis values in the reference's unsigned range.

        The Linux js API gives int16 [-32767, 32767]; winmm gave
        [0, 65535]. Shift by 32767 so existing min/max calibration files
        (config/frsky.json style) remain meaningful.
        """
        if self.device is None:
            self.last_raw = np.zeros(self.N_CHANNELS)
            return np.zeros((1, self.N_CHANNELS))
        axes, _ = self.device.read()
        vals = np.zeros(self.N_CHANNELS)
        n = min(self.N_CHANNELS, len(axes))
        vals[:n] = axes[:n].astype(np.float64) + 32767.0
        self.last_raw = vals
        return vals[None, :]

    def norm_read(self) -> np.ndarray:
        """(1, 6) in [-1, 1] (get_sticks.py:250-252)."""
        return map_from_to(self.read(), self.min_vals, self.max_vals, -1.0, 1.0)

    def calib_read(self) -> np.ndarray:
        """(6,) calibrated reading (get_sticks.py:254-265)."""
        raw = torch.from_numpy(np.asarray(self.read()[0], np.float64))
        reading = calib_transform(
            raw, np.asarray(self.min_vals, np.float64), np.asarray(self.max_vals, np.float64),
            np.asarray(self.sign_reverse, np.float64),
            [self.sticks[k]["idx"] for k in self.sticks],
            [self.sticks[k]["center"] for k in self.sticks]).numpy()
        self.calib_reading = reading
        return reading

    def read_action(self) -> np.ndarray:
        """Acro action [-roll, pitch, yaw, throttle] from the calibrated
        channels (components.py:250-253's read_sticks)."""
        r = self.calib_read()

        def ch(name, default):
            return r[self.sticks[name]["idx"]] if name in self.sticks else default

        throttle = ch("Throttle", r[0])
        roll = ch("Roll", r[1])
        pitch = ch("Pitch", r[2])
        yaw = ch("Yaw", r[5] if len(r) > 5 else 0.0)
        return np.array([-roll, pitch, yaw, throttle])

    # ---- live calibration views (get_sticks.py:62-99) ---------------------

    AXIS_NAMES = ("X", "Y", "Z", "R", "U", "V")  # winmm's axis order

    def make_fig_bars(self, ax=None):
        """Bar chart of the 6 raw axis values (get_sticks.py:62-72's
        make_fig_bars, minus the winmm button strip — the Linux adapter
        exposes buttons separately). Draws onto ``ax`` (default: current
        axes), so it works headless under the Agg backend for testing."""
        import matplotlib.pyplot as plt

        ax = ax if ax is not None else plt.gca()
        ax.bar(list(self.AXIS_NAMES), list(self.last_raw))
        ax.set_ylim(0, 65535)  # :72
        return ax

    def make_fig_axes(self, axs=None):
        """2D stick-position plots (yaw/throttle, roll/pitch) + switch bars
        from the last calibrated reading (get_sticks.py:74-93)."""
        import matplotlib.pyplot as plt

        if axs is None:
            fig = plt.gcf()
            fig.clf()
            axs = fig.subplots(1, 3)
        alpha = 0.2
        for ax, (kx, ky) in zip(axs[:2], (("Yaw", "Throttle"),
                                          ("Roll", "Pitch"))):
            ax.plot([-1, 1], [0, 0], "b", lw=3, alpha=alpha)  # :77-78
            ax.plot([0, 0], [-1, 1], "b", lw=3, alpha=alpha)
            if kx in self.sticks and ky in self.sticks:
                ax.scatter(self.calib_reading[self.sticks[kx]["idx"]],
                           self.calib_reading[self.sticks[ky]["idx"]])
            ax.set_xlim(-1, 1)
            ax.set_ylim(-1, 1)
            ax.set_aspect("equal")  # :80 axis('square')
        names = [k for k in self.switches if "idx" in self.switches[k]]
        axs[2].bar(names,
                   [self.calib_reading[self.switches[k]["idx"]]
                    for k in names])
        axs[2].set_ylim(-1, 1)  # :93
        return axs

    @staticmethod
    def _has_display() -> bool:
        return bool(os.environ.get("DISPLAY")
                    or os.environ.get("WAYLAND_DISPLAY"))

    def _render_live(self, make_fig) -> None:
        """drawnow-equivalent: clear, draw, flush — display-gated (no-op
        headless; this hardware has no display server)."""
        if not self._has_display():
            return
        import matplotlib.pyplot as plt

        plt.clf()
        make_fig()
        plt.pause(0.001)

    def render_bars(self) -> None:
        self._render_live(self.make_fig_bars)

    def render_axes(self) -> None:
        self._render_live(self.make_fig_axes)

    def live_view(self, t_sec: float = 10.0, rps: int = 20,
                  mode: str = "axes") -> None:
        """Live read loop with rendering (get_sticks.py:268-283's main):
        calibrated axes view or raw bars at ``rps`` Hz for ``t_sec``."""
        for _ in range(int(t_sec * rps)):
            self.calib_read()
            (self.render_axes if mode == "axes" else self.render_bars)()
            sleep(1.0 / rps)

    # ---- calibration persistence ------------------------------------------

    def load_calibration(self, path) -> None:
        data = json_reader(path)
        self.min_vals = np.array(data["min_vals"])
        self.max_vals = np.array(data["max_vals"])
        self.sticks = data["sticks"]
        self.switches = data["switches"]
        self.sign_reverse = np.asarray(data["sign_reverse"])
        self.calib = True

    def save_calibration(self, path) -> None:
        json_writer(
            {
                "sticks": self.sticks,
                "switches": self.switches,
                "min_vals": np.asarray(self.min_vals).tolist(),
                "max_vals": np.asarray(self.max_vals).tolist(),
                "sign_reverse": np.asarray(self.sign_reverse).tolist(),
            },
            path,
        )

    # ---- wizard (get_sticks.py:101-223) -----------------------------------

    def calibrate(self, calibration_file_path,
                  load_calibration_file: bool = True) -> None:
        if load_calibration_file and os.path.exists(calibration_file_path):
            self.load_calibration(calibration_file_path)
            return
        if load_calibration_file:
            raise FileNotFoundError(
                f"Calibration file does not exist: {calibration_file_path}")
        if self.device is None:
            raise OSError("calibration wizard requires a connected joystick")
        self._run_wizard(calibration_file_path)

    def _record(self, t_sec: float, rps: int = 100, text: Optional[str] = None,
                norm: bool = False) -> np.ndarray:
        if text:
            print(text)
        live = self._has_display()  # live bars during wizard records
        reader = self.norm_read if norm else self.read
        readings = reader()
        for i in range(int(t_sec * rps)):
            readings = np.vstack((readings, reader()))
            if live and i % (rps // 10 or 1) == 0:
                self.render_bars()
            sleep(1.0 / rps)
        return readings

    @staticmethod
    def _settled_center(readings: np.ndarray) -> np.ndarray:
        """Mean of the trailing constant segment (get_sticks.py:120-124)."""
        i = 2
        for i in range(2, len(readings)):
            if readings[-i:].std(axis=0).mean() > 1e-16:
                break
        return readings[-i + 1:].mean(axis=0, keepdims=True)

    def _run_wizard(self, save_path) -> None:
        readings = self._record(4, text="Move the sticks to all edges.")[1:]
        stds = readings.std(axis=0)
        if not np.any(stds > 1e-16):
            raise ValueError("No sticks detected; move the sticks and retry.")
        active_axes = np.sort(np.argsort(stds)[::-1][:4])
        self._record(2, text="Center all sticks.")

        sw = self._record(3, text="Move the switches all the way (2 switches).")[1:]
        sw_stds = sw.std(axis=0)
        if not np.any(sw_stds > 1e-16):
            raise ValueError("No switches detected.")
        active_switches = np.sort(np.argsort(sw_stds)[::-1][:2])

        both = np.vstack((readings, sw))
        self.min_vals = both.min(axis=0)
        self.max_vals = both.max(axis=0)
        self.sign_reverse = np.ones(self.N_CHANNELS)

        centers = self._settled_center(
            self._record(2, text="Center all sticks.", norm=True))
        self.sticks = {"Throttle": {}, "Yaw": {}, "Pitch": {}, "Roll": {}}
        commands = ["up", "to the right"]
        for i, k in enumerate(self.sticks):
            r = self._record(5, text=f"Move the {k} stick {commands[i % 2]}.",
                             norm=True)
            idx = active_axes[np.argmax(r[:, active_axes].std(axis=0))]
            self.sticks[k]["idx"] = int(idx)
            self.sign_reverse[idx] = np.sign(r[np.argmax(np.abs(r[:, idx])), idx])
            centers = np.vstack(
                (centers, self._settled_center(
                    self._record(3, text="Center all sticks.", norm=True))))
        center = centers.mean(axis=0)
        for k in self.sticks:
            self.sticks[k]["center"] = float(center[self.sticks[k]["idx"]])

        self.switches = {"AUX1": {}, "AUX2": {}}
        for k in self.switches:
            r = self._record(4, text=f"Toggle {k} repeatedly.", norm=True)
            idx = active_switches[np.argmax(r[:, active_switches].std(axis=0))]
            self.switches[k]["idx"] = int(idx)
            for attempt in range(3):
                on = self._record(3, text=f"Turn {k} on.", norm=True)[-1, idx]
                off = self._record(3, text=f"Turn {k} off.", norm=True)[-1, idx]
                if on != off:
                    self.sign_reverse[idx] = np.sign(on - off)
                    break
                print("Could not identify switch direction; retrying.")
            else:
                raise ValueError(f"Could not identify {k} direction.")

        self.save_calibration(save_path)
        self.calib = True
