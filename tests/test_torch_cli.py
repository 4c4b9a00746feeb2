"""The port's CLI (``fpyv_tpu_torch.cli``) against the JAX package's
(``fpyv_tpu.cli``), both driven in-process through ``main([...])`` with
their JSON lines read from ``capsys``: the parsers' subcommands and flags,
``sim`` (headless, guided and not), ``hover-time`` on a bench CSV written
here, ``train``'s keys, ``calibrate`` with a stand-in joystick; and the
port's own ``parity`` (float64 against its oracle copy) and ``bench``
refusal. One test runs ``python -m fpyv_tpu_torch.cli`` as a process and
reads its import trace: no JAX, no module of the JAX package.

Tolerances: the simulator's final state as tests/test_torch_simulator.py
states them (``TOL``); the rest equal.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fpyv_tpu import cli as jcli
from fpyv_tpu_torch import cli as tcli

ROOT = Path(__file__).resolve().parents[1]
TOL = {"final_position": 1e-5, "final_velocity": 1e-4}  # tests/test_torch_simulator.py
FRSKY_STYLE_CALIB = {
    "sticks": {
        "Throttle": {"idx": 0, "center": 0.088},
        "Roll": {"idx": 1, "center": -0.081},
        "Pitch": {"idx": 2, "center": -0.012},
        "Yaw": {"idx": 5, "center": -0.004},
    },
    "switches": {"AUX1": {"idx": 3}, "AUX2": {"idx": 4}},
    "min_vals": [0, 4902, 774, 0, 0, 258],
    "max_vals": [48371, 65535, 65535, 65535, 65535, 65535],
    "sign_reverse": [1, 1, 1, 1, 1, 1],
}


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser JAX's ``main`` builds (it builds it inline): caught at its
    ``parse_args``."""
    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as got:
            jcli.main([])
    return got.value.args[0]


def _subparsers(parser) -> dict:
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(parser) -> dict:
    return {s: a for a in parser._actions for s in a.option_strings}


def _run(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parser_matches_jax(monkeypatch):
    jsubs, tsubs = _subparsers(_jax_parser(monkeypatch)), _subparsers(tcli.build_parser())
    assert set(tsubs) == set(jsubs) == {"sim", "train", "play", "bench", "parity", "calibrate",
                                        "hover-time"}
    for name, jp in jsubs.items():
        jopt, topt = _options(jp), _options(tsubs[name])
        assert set(topt) == set(jopt) | {"--device"}, name
        for flag, ja in jopt.items():
            ta = topt[flag]
            for attr in ("dest", "default", "type", "choices", "required", "nargs", "const"):
                assert getattr(ta, attr) == getattr(ja, attr), (name, flag, attr)
    assert _options(tcli.build_parser())["--device"].default == "cuda"
    # --device before or after the subcommand; the subcommand's wins only when given
    parse = tcli.build_parser().parse_args
    assert parse(["sim"]).device == "cuda"
    assert parse(["--device", "cpu", "sim"]).device == "cpu"
    assert parse(["sim", "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("guided", [True, False])
def test_sim_matches_jax(guided, capsys):
    argv = ["sim", "--steps", "60"] + ([] if guided else ["--no-guidance"])
    ref = _run(jcli.main, argv, capsys)
    out = _run(tcli.main, ["--device", "cpu"] + argv, capsys)
    assert set(out) == set(ref)
    assert out["steps"] == ref["steps"] == 60 and out["crashed"] is ref["crashed"] is False
    for k, tol in TOL.items():
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=tol, err_msg=k)


def test_parity_passes(capsys):
    out = _run(tcli.main, ["parity", "--steps", "300", "--device", "cpu"], capsys)
    assert out["steps"] == 300 and out["pass"] is True
    assert out["max_position_error"] < 1e-8 and out["max_attitude_error"] < 1e-8


def _write_bench_csv(path: Path) -> None:
    """Two motor variants in the T-Motor bench layout ``io/motor_csv.py``
    reads: a header row, '%' throttles, decimal commas, a block closed by
    its 100 % row."""
    rows = ["Type,Propeller,Throttle,Thrust,Voltage,Current,RPM,Power,Efficiency,Temperature"]
    for name, prop, scale in (("F80 Pro KV1900", "5055", 1.0), ("F80 Pro KV2200", "5043", 1.2)):
        for i, thr in enumerate(range(50, 105, 5)):
            thrust = scale * (400.0 + 90.0 * i + 3.5 * i * i)
            power = scale * (120.0 + 60.0 * i + 6.0 * i * i)
            volt = 24.6 - 0.1 * i
            thrust_s, power_s = f"{thrust:.1f}".replace(".", ","), f"{power:.2f}".replace(".", ",")
            rows.append(f'{name if i == 0 else ""},{prop if i == 0 else ""},{thr}%,"{thrust_s}",'
                        f'{volt:.2f},{power / volt:.2f},{15000 + 900 * i},"{power_s}",'
                        f'{thrust / power:.3f},{40 + i}')
    path.write_text("\n".join(rows) + "\n")


def test_hover_time_matches_jax(tmp_path, capsys):
    path = tmp_path / "bench.csv"
    _write_bench_csv(path)
    for idx in ("0", "1"):
        argv = ["hover-time", "--csv", str(path), "--idx", idx, "--dry-mass", "250"]
        ref = _run(jcli.main, argv, capsys)
        out = _run(tcli.main, ["--device", "cpu"] + argv, capsys)
        assert out == ref
        assert ref["detected_cells"] == 6 and 0 < ref["max_hover_time_minutes"] < 120


def test_train_gives_jax_keys(monkeypatch, capsys):
    from fpyv_tpu.apps import train as jtrain

    # JAX's keys without JAX's compile: its trainer stands in
    monkeypatch.setattr(jtrain, "train_acro", lambda **kw: jtrain.TrainResult(
        iterations=kw["num_iterations"], mean_reward_first=0.0, mean_reward_last=0.0,
        steps_per_second=1.0))
    argv = ["train", "--num-envs", "16", "--iterations", "1"]
    ref = _run(jcli.main, argv, capsys)
    out = _run(tcli.main, ["--device", "cpu"] + argv + ["--num-steps", "4"], capsys)
    assert set(out) == set(ref)
    assert out["iterations"] == 1 and np.isfinite(out["mean_reward_first"])


def test_bench_refuses():
    with pytest.raises(SystemExit) as e:
        tcli.main(["bench"])
    assert e.value.code not in (0, None)
    assert "bench.py" in str(e.value.code) and "chip_smoke.py" in str(e.value.code)


def test_calibrate_headless_matches_jax(tmp_path, monkeypatch, capsys):
    from fpyv_tpu.inputs import rc as jrc
    from fpyv_tpu_torch.inputs import rc as trc

    path = tmp_path / "calib.json"
    path.write_text(json.dumps(FRSKY_STYLE_CALIB))
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)

    def fake(base):
        class FakeJoystick(base):
            def __init__(self, index=0):
                super().__init__(index=99)  # no real device
                self.ret = True  # pretend connected

            def read(self):
                self.last_raw = np.asarray([20000.0, 40000.0, 30000.0, 65535.0, 0.0, 32767.0])
                return self.last_raw[None, :]
        return FakeJoystick

    real = trc.Joystick
    monkeypatch.setattr(jrc, "Joystick", fake(jrc.Joystick))
    monkeypatch.setattr(trc, "Joystick", fake(real))
    argv = ["calibrate", "--calibration", str(path), "--live", "0.1", "--rps", "10"]
    ref = _run(jcli.main, argv, capsys)
    out = _run(tcli.main, argv, capsys)
    assert out == ref
    assert out["live_seconds"] == 0.1 and len(out["action"]) == 4
    monkeypatch.setattr(trc, "Joystick", real)
    with pytest.raises(SystemExit):  # no device: refused, as JAX's
        tcli.main(["calibrate", "--index", "97", "--calibration", str(tmp_path / "none.json")])


def test_cli_process_imports_no_jax():
    """``python -m fpyv_tpu_torch.cli`` as a user runs it: its JSON line, and
    an import trace with no JAX and no module of the JAX package."""
    res = subprocess.run([sys.executable, "-X", "importtime", "-m", "fpyv_tpu_torch.cli",
                          "--device", "cpu", "parity", "--steps", "50"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["pass"] is True
    imported = {line.split("|")[-1].strip().split(".")[0]
                for line in res.stderr.splitlines() if line.startswith("import time:")}
    assert "fpyv_tpu_torch" in imported
    bad = imported & {"jax", "jaxlib", "flax", "optax", "orbax", "fpyv_tpu", "tools"}
    assert not bad, bad
