"""The port's ``viz/``, ``inputs/`` and flight-log modules against the JAX
package's: ``Trail`` (scalar and batched heads, partial fill, wrap),
``calib_transform`` and the ``Joystick`` class, ``VirtualTarget``, the HUD,
the video sink, the matplotlib views, the native builds; and the JAX
package's own cases for the serial parsers, the RC calibration and the
blackbox decoder, run against the port's modules.

Those cases are mirrored, not copied: ``_mirror`` imports the JAX test file
under another name with the JAX modules it tests mapped to the port's for
the length of the import, and this module re-exports its test classes, so
pytest runs each JAX case on the port's functions. Their native libraries
build from ``native/*.cpp`` into ``build/native/``, never beside the
sources, so they do not race the JAX tests' builds there.

Tolerances: everything here is equal (float64 or exact selections), the
video's frame count included.
"""

import ctypes
import importlib.util
import json
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fpyv_tpu.inputs.build_native  # noqa: F401  (the JAX modules load before _mirror maps them)
import fpyv_tpu.io.blackbox_native  # noqa: F401
import fpyv_tpu.io.logs  # noqa: F401
from fpyv_tpu.inputs import mouse as jmouse
from fpyv_tpu.inputs import rc as jrc
from fpyv_tpu.inputs import serial_readers as jserial
from fpyv_tpu.viz import hud as jhud
from fpyv_tpu.viz import pid_plot as jpid
from fpyv_tpu.viz import render3d as j3d
from fpyv_tpu.viz.trail import Trail as JTrail
from fpyv_tpu_torch.inputs import build_native as tbuild
from fpyv_tpu_torch.inputs import mouse as tmouse
from fpyv_tpu_torch.inputs import rc as trc
from fpyv_tpu_torch.inputs import serial_readers as tserial
from fpyv_tpu_torch.io import blackbox_native as tbbx
from fpyv_tpu_torch.io import logs as tlogs
from fpyv_tpu_torch.viz import hud as thud
from fpyv_tpu_torch.viz import pid_plot as tpid
from fpyv_tpu_torch.viz import render3d as t3d
from fpyv_tpu_torch.viz.trail import Trail as TTrail
from fpyv_tpu_torch.viz.video import VideoWriterSink

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def _mirror(test_file: str, swaps: dict):
    """``tests/<test_file>`` imported with ``sys.modules[name]`` set to the
    port's module for each JAX module name in ``swaps`` during the import
    (restored after it), so its ``from fpyv_tpu... import`` lines bind the
    port's functions."""
    saved = {name: sys.modules[name] for name in swaps}
    sys.modules.update(swaps)
    try:
        spec = importlib.util.spec_from_file_location(
            "_port_" + test_file.removesuffix(".py"), TESTS / test_file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.modules.update(saved)
    return mod


_inputs = _mirror("test_inputs.py", {"fpyv_tpu.inputs.build_native": tbuild,
                                     "fpyv_tpu.inputs.rc": trc})
TestCalibration = _inputs.TestCalibration
TestCalibrationViews = _inputs.TestCalibrationViews
_serial = _mirror("test_serial_and_misc.py", {"fpyv_tpu.inputs.serial_readers": tserial})
TestGyroglove = _serial.TestGyroglove
TestRx5808 = _serial.TestRx5808
TestTimingSystem = _serial.TestTimingSystem
TestVelocidrone = _serial.TestVelocidrone
_blackbox = _mirror("test_blackbox.py", {"fpyv_tpu.io.blackbox_native": tbbx,
                                         "fpyv_tpu.io.logs": tlogs})
TestRoundTrip = _blackbox.TestRoundTrip
TestMultiLog = _blackbox.TestMultiLog
TestSlowFrames = _blackbox.TestSlowFrames
TestRobustness = _blackbox.TestRobustness


def test_mirrored_cases_bind_the_port():
    assert _inputs.Joystick is trc.Joystick and _inputs.calib_transform is trc.calib_transform
    assert _serial.parse_gyroglove is tserial.parse_gyroglove
    assert _blackbox.decode_blackbox is tbbx.decode_blackbox
    assert _blackbox.blackbox_parser is tlogs.blackbox_parser
    assert sys.modules["fpyv_tpu.inputs.rc"] is jrc  # restored


# ---------------------------------------------------------------------------
# Trail
# ---------------------------------------------------------------------------


def _trail_equal(t: TTrail, j: JTrail):
    for name in ("points", "head", "count"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(t.ordered().numpy(), np.asarray(j.ordered()))


@pytest.mark.parametrize("length,batch,updates", [(4, (), 6), (8, (), 2), (5, (3,), 12),
                                                  (6, (2, 3), 4)])
def test_trail_matches_jax(length, batch, updates):
    rng = np.random.default_rng(length)
    p0 = rng.normal(size=batch + (3,)).astype(np.float32)
    t = TTrail.create(length, torch.from_numpy(p0), batch_shape=batch)
    j = JTrail.create(length, jnp.asarray(p0), batch_shape=batch)
    _trail_equal(t, j)
    for _ in range(updates):  # partial fill, then wrap where updates >= length
        p = rng.normal(size=batch + (3,)).astype(np.float32)
        t, j = t.update(torch.from_numpy(p)), j.update(jnp.asarray(p))
        _trail_equal(t, j)
    assert t.points.dtype == torch.float32 and t.head.dtype == torch.int32


# ---------------------------------------------------------------------------
# RC inputs
# ---------------------------------------------------------------------------

CALIB = _inputs.FRSKY_STYLE_CALIB


def test_calib_transform_matches_jax():
    rng = np.random.default_rng(0)
    mn, mx = np.asarray(CALIB["min_vals"], np.float64), np.asarray(CALIB["max_vals"], np.float64)
    raws = rng.uniform(mn, mx, (4, 32, 6))
    raws[0, :, 1] = (CALIB["sticks"]["Roll"]["center"] + 1) / 2 * (mx[1] - mn[1]) + mn[1]
    idx = [s["idx"] for s in CALIB["sticks"].values()]
    ctr = [s["center"] for s in CALIB["sticks"].values()]
    sign = np.asarray([1, -1, 1, 1, -1, 1], np.float64)
    ref = np.asarray(jrc.calib_transform(raws, mn, mx, sign, idx, ctr))
    out = trc.calib_transform(torch.from_numpy(raws), mn, mx, sign, idx, ctr)
    assert out.dtype == torch.float64 and out.shape == raws.shape
    np.testing.assert_array_equal(out.numpy(), ref)
    # numpy in, a tensor out; float32 on the tensor's dtype
    out32 = trc.calib_transform(raws.astype(np.float32), mn, mx, sign, idx, ctr)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), ref, atol=1e-6)


def test_joystick_round_trip_matches_jax(tmp_path):
    path = tmp_path / "calib.json"
    path.write_text(json.dumps(CALIB))
    js = {}
    for name, mod in (("jax", jrc), ("port", trc)):
        j = mod.Joystick(index=15)  # surely absent
        assert j.status is False and j.read().shape == (1, 6)
        j.load_calibration(path)
        j.save_calibration(tmp_path / f"{name}.json")
        js[name] = j
    assert (json.loads((tmp_path / "port.json").read_text())
            == json.loads((tmp_path / "jax.json").read_text()))
    raws = np.random.default_rng(1).uniform(js["port"].min_vals, js["port"].max_vals, (16, 6))
    for raw in raws:
        for j in js.values():
            j.read = lambda raw=raw: raw[None, :]
        np.testing.assert_array_equal(js["port"].calib_read(), js["jax"].calib_read())
        np.testing.assert_array_equal(js["port"].read_action(), js["jax"].read_action())


def test_virtual_target_matches_jax():
    events = ([("down", 100, 50)] + [("move", 100, 50)] * 20 + [("up", 100, 50)]
              + [("move", 400, 400)] * 10 + [("other", 3, 4)])
    t, j = tmouse.VirtualTarget((640, 480)), jmouse.VirtualTarget((640, 480))
    for ev in events:
        t.on_event(*ev)
        j.on_event(*ev)
        assert t.pixel() == j.pixel()


def test_serial_helpers_match_jax():
    stream = "\r\n".join([tserial.make_timing_message(1000000000 + i, "11:22:33:44:55:66",
                                                      -40 - i) for i in range(5)]) + "\r\n$bad"
    assert tserial.parse_timing_stream(stream) == jserial.parse_timing_stream(stream)
    assert tserial.RX5808_FREQS == jserial.RX5808_FREQS
    text = "Position: 1 2 3\r\nPosition: 4 5 6\r\nquaternion: w: 1, x: 2, y: 3, z: 4\r\nq"
    a, b = tserial.parse_gyroglove(text), jserial.parse_gyroglove(text)
    np.testing.assert_array_equal(a.position, b.position)


def test_native_builds_land_in_build_native():
    """The port's g++ builds go to ``build/native/``, not ``native/``; forced
    builds from several threads at once each leave a loadable library (a
    temporary file renamed into place)."""
    for build, symbol in ((tbuild.build_joystick_lib, "fj_num_devices"),
                          (tbbx.build_blackbox_lib, "bbx_open")):
        lib = build()
        assert lib is not None and lib.parent == ROOT / "build" / "native" and lib.exists()
        assert hasattr(ctypes.CDLL(str(lib)), symbol)
    got = []
    threads = [threading.Thread(target=lambda: got.append(tbuild.build_joystick_lib(force=True)))
               for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads) and len(got) == 3
    assert all(p == tbuild.BUILD_DIR / "libfpyv_joystick.so" for p in got)
    assert hasattr(ctypes.CDLL(str(got[0])), "fj_num_devices")
    assert not list(tbuild.BUILD_DIR.glob(".*.tmp"))
    from fpyv_tpu_torch.inputs import joystick_native

    assert isinstance(joystick_native.num_devices(), int)


# ---------------------------------------------------------------------------
# HUD, video, matplotlib views
# ---------------------------------------------------------------------------


def _frame(seed=0, hw=(48, 64)):
    return np.random.default_rng(seed).integers(0, 256, hw, dtype=np.uint8)


def test_hud_matches_jax():
    f = _frame()
    kw = dict(target_pixel=(20.4, 10.9), setpoint_pixel=(30, 20), dist_to_target=5.678,
              speed_ms=3.2, throttle=-0.25, height_m=2.5)
    out, ref = thud.hud_overlay(f, **kw), jhud.hud_overlay(f, **kw)
    np.testing.assert_array_equal(out, ref)
    assert (out != f).any()  # the text was drawn
    np.testing.assert_array_equal(thud.hud_overlay(f), f)


def test_hud_without_cv2_returns_the_frame(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    f = _frame(1)
    np.testing.assert_array_equal(thud.hud_overlay(f, speed_ms=1.0), f)


def test_video_sink_writes_every_frame(tmp_path):
    import cv2

    path = tmp_path / "clip.mp4"
    with VideoWriterSink(str(path), fps=30.0) as sink:
        for i in range(7):
            sink(_frame(i))
    assert sink.frames_written == 7 and path.stat().st_size > 0
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 7


def test_video_sink_without_cv2_raises_at_the_first_frame(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    sink = VideoWriterSink(str(tmp_path / "none.mp4"))
    with pytest.raises(ImportError):
        sink(_frame())
    assert sink.frames_written == 0


def _agg():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


@pytest.mark.parametrize("att_mode", ["rotmat", "quat"])
def test_render3d_matches_jax(att_mode, monkeypatch):
    from fpyv_tpu.physics.drone import DroneParams as JP
    from fpyv_tpu.physics.drone import drone_reset as jreset
    from fpyv_tpu_torch.physics.drone import DroneParams as TP
    from fpyv_tpu_torch.physics.drone import drone_reset as treset

    plt = _agg()
    monkeypatch.setattr(plt, "pause", lambda *a: None)
    pos, vel, ypr = [1.0, 2.0, 3.0], [0.5, 0.0, -0.2], [10.0, -20.0, 30.0]
    states = (treset(TP(att_mode=att_mode), torch.tensor(pos), torch.tensor(vel),
                     torch.tensor(ypr)),
              jreset(JP(att_mode=att_mode), jnp.asarray(pos, jnp.float32),
                     jnp.asarray(vel, jnp.float32), jnp.asarray(ypr, jnp.float32)))
    drawn = []
    for mod, st, params in ((t3d, states[0], TP(att_mode=att_mode)),
                            (j3d, states[1], JP(att_mode=att_mode))):
        ax, fig = mod.init_3d_axis()
        mod.render_drone(ax, st, params, velocity=True)
        mod.plot_3d_line(ax, np.zeros((4, 3)) + np.arange(4)[:, None])
        mod.show_plot(ax, fig, middle=st.pos, edge=5)
        drawn.append(([c.__class__.__name__ for c in ax.collections], ax.get_xlim()))
        plt.close(fig)
    assert drawn[0][0] == drawn[1][0] and len(drawn[0][0]) > 4
    np.testing.assert_allclose(drawn[0][1], drawn[1][1], atol=1e-5)


def test_pid_plot_matches_jax(monkeypatch):
    plt = _agg()
    monkeypatch.setattr(plt, "pause", lambda *a: None)
    err, integ, der = (np.sin(np.arange(50) * k) for k in (0.1, 0.2, 0.3))
    lines = []
    for mod in (tpid, jpid):
        fig = plt.figure()
        mod.plot_pid_history(err, integ, der)
        lines.append([[ln.get_ydata().tolist() for ln in ax.lines] for ax in fig.axes])
        plt.close(fig)
    assert lines[0] == lines[1] and len(lines[0]) == 3
