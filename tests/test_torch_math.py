"""The port's rotations, polynomials and thrust curve against the JAX
package, on the CPU with the same numpy inputs.

Tolerances: float32 functions agree to a few ulps (atol 1e-6 on unit-scale
outputs; the two libraries' sin/cos/atan2 differ in the last bit). The
thrust-curve fit runs in numpy float64 in both packages, so its
coefficients must be equal exactly.
"""

import dataclasses
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpyv_tpu.ops import poly as jpoly
from fpyv_tpu.ops import rotations as jrot
from fpyv_tpu.physics import motor as jmotor
from fpyv_tpu_torch.ops import poly as tpoly
from fpyv_tpu_torch.ops import rotations as trot
from fpyv_tpu_torch.physics import motor as tmotor

RNG = np.random.default_rng(0)
EULER = RNG.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
QUAT = RNG.normal(size=(64, 4)).astype(np.float32)
QUAT /= np.linalg.norm(QUAT, axis=-1, keepdims=True)
VEC = RNG.uniform(-3, 3, (64, 3)).astype(np.float32)
RATES = RNG.uniform(-300, 300, (64, 3)).astype(np.float32)
AXIS = VEC / np.linalg.norm(VEC, axis=-1, keepdims=True)
ANGLE = RNG.uniform(0.1, 3.0, 64).astype(np.float32)


def _rotmat():
    return np.asarray(jrot.euler_to_rotmat(jnp.asarray(EULER)))


CASES = {
    "euler_to_rotmat": lambda m: m.euler_to_rotmat(_t(m, EULER)),
    "rotmat_to_euler": lambda m: m.rotmat_to_euler(_t(m, _rotmat())),
    "euler_to_quat": lambda m: m.euler_to_quat(_t(m, EULER)),
    "quat_to_rotmat": lambda m: m.quat_to_rotmat(_t(m, QUAT)),
    "rotmat_to_quat": lambda m: m.rotmat_to_quat(_t(m, _rotmat())),
    "quat_mul": lambda m: m.quat_mul(_t(m, QUAT), _t(m, QUAT[::-1].copy())),
    "quat_conj": lambda m: m.quat_conj(_t(m, QUAT)),
    "quat_normalize": lambda m: m.quat_normalize(_t(m, QUAT * 3.0)),
    "quat_rotate": lambda m: m.quat_rotate(_t(m, QUAT), _t(m, VEC)),
    "quat_inverse_rotate": lambda m: m.quat_inverse_rotate(_t(m, QUAT), _t(m, VEC)),
    "mat3_mul": lambda m: m.mat3_mul(_t(m, _rotmat()), _t(m, _rotmat()[::-1].copy())),
    "mat3_vec": lambda m: m.mat3_vec(_t(m, _rotmat()), _t(m, VEC)),
    "mat3_vec_T": lambda m: m.mat3_vec_T(_t(m, _rotmat()), _t(m, VEC)),
    "rotmat_xyz": lambda m: [f(_t(m, EULER[:, 0])) for f in (m.rotmat_x, m.rotmat_y, m.rotmat_z)],
    "rotate_body_by_rates": lambda m: m.rotate_body_by_rates(_t(m, _rotmat()), _t(m, RATES),
                                                             1.0 / 60.0),
    "quat_rotate_by_rates": lambda m: m.quat_rotate_by_rates(_t(m, QUAT), _t(m, RATES),
                                                             1.0 / 60.0),
    "axis_angle_to_rotmat": lambda m: m.axis_angle_to_rotmat(_t(m, AXIS), _t(m, ANGLE)),
    "rotmat_to_axis_angle": lambda m: m.rotmat_to_axis_angle(
        m.axis_angle_to_rotmat(_t(m, AXIS), _t(m, ANGLE))),
    "quat_from_axis_angle": lambda m: m.quat_from_axis_angle(_t(m, AXIS), _t(m, ANGLE)),
    "distance_point_to_plane": lambda m: m.distance_point_to_plane(
        _t(m, VEC), _t(m, np.concatenate([AXIS, VEC[:, :1]], -1))),
    # host-side helper: float64 here (the test process runs JAX with x64 on)
    "generate_circular_path": lambda m: m.generate_circular_path(
        [1.0, 2.0, 3.0], 25.0, 40,
        **({"dtype": torch.float64, "device": "cpu"} if m is trot else {})),
}


def _t(mod, x):
    return torch.from_numpy(np.array(x, copy=True)) if mod is trot else jnp.asarray(x)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_rotation_function_matches_jax(name):
    ref = _flat(CASES[name](jrot))
    out = _flat(CASES[name](trot))
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert o.shape == r.shape and o.dtype == r.dtype
        # unit-scale f32 outputs: a few ulps (libm sin/cos/atan2 differ)
        np.testing.assert_allclose(o, r, atol=2e-6, err_msg=name)


def test_quat_identity():
    np.testing.assert_array_equal(trot.quat_identity((3,), device="cpu").numpy(),
                                  np.asarray(jrot.quat_identity((3,))))


def test_quat_and_rotmat_rate_updates_agree():
    """The quaternion twin composes the same per-axis rotation as the
    reference's matrix update (float32 precision)."""
    q = torch.from_numpy(QUAT)
    R = trot.quat_to_rotmat(q)
    rates = torch.from_numpy(RATES)
    a = trot.quat_to_rotmat(trot.quat_rotate_by_rates(q, rates, 1 / 60))
    b = trot.rotate_body_by_rates(R, rates, 1 / 60)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_polyval_matches_jax(dtype):
    coeffs = (1.5e-4, -0.02, 0.9, 0.1)
    x = RNG.uniform(0, 100, 257).astype(dtype)
    out = tpoly.polyval(coeffs, torch.from_numpy(x)).numpy()
    ref = np.asarray(jpoly.polyval(coeffs, jnp.asarray(x)))
    assert out.dtype == ref.dtype
    # same Horner chain in the same dtype; f32 needs ulps for the libraries' FMA choices
    np.testing.assert_allclose(out, ref, rtol=1e-6 if dtype == np.float32 else 1e-14)


def test_fit_poly_through_origin_is_the_same_fit():
    x, y = RNG.uniform(0, 10, 12), RNG.uniform(0, 5, 12)
    np.testing.assert_array_equal(tpoly.fit_poly_through_origin(x, y),
                                  jpoly.fit_poly_through_origin(x, y))


@pytest.mark.parametrize("idx", range(len(jmotor.F80_BENCH_TABLES)))
def test_thrust_curve_coefficients_exact(idx):
    a = tmotor.default_thrust_curve(idx)
    b = jmotor.default_thrust_curve(idx)
    assert a.throttle2thrust_coeffs == b.throttle2thrust_coeffs
    assert a.thrust2throttle_coeffs == b.thrust2throttle_coeffs
    assert (a.min_force, a.max_force) == (b.min_force, b.max_force)
    assert (a.motor_name, a.propeller) == (b.motor_name, b.propeller)


def test_thrust_curve_from_csv_exact(tmp_path):
    rows = ["Type,Propeller,Throttle,Thrust,Voltage,Current,RPM,Power,Efficiency,Temperature"]
    for name, prop, grams in jmotor.F80_BENCH_TABLES[:2]:
        for i, (thr, g) in enumerate(zip(np.arange(50.0, 101.0, 5.0), grams)):
            rows.append(f"{name if i == 0 else ''},{prop if i == 0 else ''},{thr:g}%,"
                        f"\"{str(g).replace('.', ',')}\",24,10,20000,\"240,5\",4,40")
    path = tmp_path / "bench.csv"
    path.write_text("\n".join(rows) + "\n")
    for idx in (0, 1):
        a = tmotor.thrust_curve_from_csv(path, idx)
        b = jmotor.thrust_curve_from_csv(path, idx)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_thrust_curve_evaluation_matches_jax():
    x = np.linspace(-1, 1, 41).astype(np.float32)
    a = tmotor.default_thrust_curve()
    np.testing.assert_allclose(a.throttle_to_thrust(torch.from_numpy(x)).numpy(),
                               np.asarray(jmotor.default_thrust_curve().throttle_to_thrust(
                                   jnp.asarray(x))), rtol=1e-6)
    f = np.linspace(1.0, 80.0, 41).astype(np.float32)
    np.testing.assert_allclose(a.thrust_to_throttle(torch.from_numpy(f)).numpy(),
                               np.asarray(jmotor.default_thrust_curve().thrust_to_throttle(
                                   jnp.asarray(f))), atol=1e-6)


def test_config_from_yaml_matches_jax():
    from fpyv_tpu.config import FpyvConfig as JCfg
    from fpyv_tpu_torch.config import FpyvConfig as TCfg

    path = Path(__file__).resolve().parents[1] / "config" / "params.yaml"
    a, b = TCfg.from_yaml(path), JCfg.from_yaml(path)
    for sect in ("simulator", "drone", "camera", "point_and_shoot"):
        assert dataclasses.asdict(getattr(a, sect)) == dataclasses.asdict(getattr(b, sect))
    assert a.extras == b.extras
