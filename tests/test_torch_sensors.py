"""The port's sensor models against the JAX package's (``fpyv_tpu.sensors``)
on the CPU: the barometer (its formula, the round trip, the reference's
ad-hoc fit, the peak detector with ``patience`` reached at samples 0 and
1, batched and with the least-squares fit), the gyro noise rotation and the
IMU observation in both attitude modes. JAX's draws are fed through the
port's draw functions (``sensors.gyro.noise_draw``, ``sensors.imu.imu_noise``,
``sensors.baro.pressure_noise``).

Tolerances: float64 throughout, 1e-12 absolute on the gyro matrices and
the IMU vectors and 1e-12 relative on pressures (the same operations;
libm's log/exp/sin/cos may differ by an ulp), 1e-11 absolute on a noisy
altitude (an ulp of the log times the 8.4 km scale height), 1e-9 on the
least-squares fit (a QR solve against JAX's SVD); the peak flags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpyv_tpu.ops.poly import quadratic_fit as j_quadratic_fit
from fpyv_tpu.physics.drone import DroneParams as JP
from fpyv_tpu.physics.drone import drone_reset as j_drone_reset
from fpyv_tpu.physics.drone import drone_step as j_drone_step
from fpyv_tpu.physics.world import empty_world as j_empty_world
from fpyv_tpu.sensors import baro as jbaro
from fpyv_tpu.sensors import gyro as jgyro
from fpyv_tpu.sensors import imu as jimu
from fpyv_tpu_torch import interop
from fpyv_tpu_torch.ops.poly import quadratic_fit
from fpyv_tpu_torch.physics.drone import DroneParams as TP
from fpyv_tpu_torch.sensors import baro, gyro, imu
from fpyv_tpu_torch.sensors import (BaroParams, altitude_from_pressure, baro_measure,
                                    gyro_noise_rotation, imu_observation, is_peak_altitude,
                                    perturb_attitude, pressure_from_altitude,
                                    quadratic_fit_reference)


@pytest.fixture(autouse=True)
def one_thread():
    """Every tensor here is small: with the suite's workers sharing the
    cores, intra-op threads only add synchronisation."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Barometer
# ---------------------------------------------------------------------------


def test_baro_formula_and_round_trip():
    p = BaroParams(init_pressure=1000.0, init_height=0.0, temperature_c=20.0)
    jp = jbaro.BaroParams(init_pressure=1000.0, init_height=0.0, temperature_c=20.0)
    h = altitude_from_pressure(torch.tensor(1000.0 - 1e-3, dtype=torch.float64), p)
    ref = np.log(1000.0 / (1000.0 - 1e-3)) * (8.31432 * 293.15) / (9.80665 * 0.0289644)
    np.testing.assert_allclose(h.item(), ref, rtol=1e-12)
    np.testing.assert_allclose(
        h.item(), float(jbaro.altitude_from_pressure(jnp.float64(1000.0 - 1e-3), jp)), rtol=1e-12)
    heights = torch.linspace(0.0, 500.0, 11, dtype=torch.float64)
    pres = pressure_from_altitude(heights)
    np.testing.assert_allclose(pres.numpy(), np.asarray(jbaro.pressure_from_altitude(
        jnp.asarray(heights.numpy()))), rtol=1e-12)
    np.testing.assert_allclose(altitude_from_pressure(pres).numpy(), heights.numpy(), atol=1e-9)


def test_baro_measure_matches_jax_with_its_noise(monkeypatch):
    jp = jbaro.BaroParams(noise_std=5.0)
    h = np.random.default_rng(0).uniform(0.0, 50.0, 256)
    key = jax.random.key(0)
    jm = jbaro.baro_measure(jnp.asarray(h), key, jp)
    noise = jax.random.normal(key, (256,), jnp.float64)
    monkeypatch.setattr(baro, "pressure_noise", lambda g, shape, dtype, device: _t(noise))
    tm = baro_measure(torch.from_numpy(h), torch.Generator(), BaroParams(noise_std=5.0))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-11, rtol=0)
    assert np.abs(tm.numpy() - h).max() > 0.01  # the noise moved the reading


def test_baro_noise_statistics():
    m = baro_measure(torch.full((20000,), 50.0, dtype=torch.float64),
                     torch.Generator().manual_seed(0), BaroParams(noise_std=5.0))
    assert abs(m.mean().item() - 50.0) < 0.1 and m.std().item() > 0.01


def test_quadratic_fit_reference_matches_jax():
    """The reference's ad-hoc fit (c pairs a with the mean and b with its
    square) reproduced, on one series and on a batch of noisy ones."""
    x = np.linspace(0, 3, 100)
    y = -x ** 2 + 2 * x + 2
    batch = y + np.random.default_rng(1).normal(0.0, 0.1, (5, 100))
    for yy in (y, batch):
        got = quadratic_fit_reference(torch.from_numpy(x), torch.from_numpy(yy))
        want = jbaro.quadratic_fit_reference(jnp.asarray(x), jnp.asarray(yy))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12, rtol=1e-12)
    a, b, c, r2 = quadratic_fit_reference(torch.from_numpy(x), torch.from_numpy(y))
    assert not np.allclose([a.item(), b.item(), c.item()], [-1.0, 2.0, 2.0])  # the quirk


def test_quadratic_fit_matches_jax():
    x = np.linspace(0, 3, 40)
    y = -x ** 2 + 2 * x + 2 + np.random.default_rng(2).normal(0.0, 0.05, 40)
    got = quadratic_fit(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_quadratic_fit(jnp.asarray(x),
                                                                       jnp.asarray(y))),
                               atol=1e-9)
    ys = np.stack([y, 2 * y, -y])  # batched over the series
    np.testing.assert_allclose(quadratic_fit(torch.from_numpy(x), torch.from_numpy(ys)).numpy(),
                               np.stack([np.asarray(j_quadratic_fit(jnp.asarray(x),
                                                                    jnp.asarray(r)))
                                         for r in ys]), atol=1e-9)


def _series():
    """Series that reach the detector's edges: rising (never), up-down (a
    peak), a plateau from sample 0 (the counter is 1 at sample 0), a drop
    at sample 1, and noisy flights."""
    x = np.linspace(0, 3, 64)
    rng = np.random.default_rng(3)
    rows = [2.0 * x, -((x - 1.5) ** 2) + 3.0, np.full(64, 1.0), np.r_[5.0, 4.0, 3.0 * x[2:]],
            np.r_[0.0, 3.0, 1.0, 1.5 * x[3:]], -((x - 0.2) ** 2) + 1.0]
    rows += [-((x - c) ** 2) + rng.normal(0.0, 0.3, 64) for c in rng.uniform(0.5, 2.5, 10)]
    return x, np.stack(rows)


@pytest.mark.parametrize("patience", [1, 2, 3, 5])
@pytest.mark.parametrize("use_reference_fit", [True, False])
def test_peak_detection_matches_jax(patience, use_reference_fit):
    """The flags of each series, and of the whole batch at once, equal
    JAX's scan (vmapped over the series) for patience reached at sample 0
    (patience 1) and 1 (patience 2) and later."""
    x, ys = _series()
    if not use_reference_fit:
        # a flat or exactly quadratic series lies on its least-squares fit,
        # where ``m < fit`` is a tie that the solver's last bit decides (a
        # QR solve here, an SVD in JAX): the fit is held on series off it
        ys = ys + np.random.default_rng(5).normal(0.0, 1e-3, ys.shape)
    jflags = np.asarray(jax.vmap(lambda m: jbaro.is_peak_altitude(
        jnp.asarray(x), m, patience, use_reference_fit))(jnp.asarray(ys)))
    batched = is_peak_altitude(torch.from_numpy(x), torch.from_numpy(ys), patience,
                               use_reference_fit)
    assert batched.dtype == torch.bool and batched.shape == (len(ys),)
    np.testing.assert_array_equal(batched.numpy(), jflags)
    for row, flag in zip(ys, jflags):
        assert bool(is_peak_altitude(torch.from_numpy(x), torch.from_numpy(row), patience,
                                     use_reference_fit)) == bool(flag)
    # premise: both outcomes occur (at patience 1 a noisy series fires anywhere)
    assert jflags.any() and (patience == 1 or not jflags.all())


def test_peak_counter_at_sample_zero():
    """JAX's carry starts at sample 0 and the scan visits it again: a flat
    series below its fit fires at patience 1 on sample 0 already."""
    x = np.linspace(0, 3, 8)
    m = np.r_[0.0, np.full(7, -1.0)]  # sample 0 lies below the fit's line here
    for p in (1, 2):
        assert bool(is_peak_altitude(torch.from_numpy(x), torch.from_numpy(m), p)) == bool(
            jbaro.is_peak_altitude(jnp.asarray(x), jnp.asarray(m), p))


# ---------------------------------------------------------------------------
# Gyro
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma,mod_quirk", [(5.0, True), (200.0, True), (200.0, False)])
def test_gyro_noise_rotation_matches_jax(sigma, mod_quirk, monkeypatch):
    key = jax.random.key(2)
    jR = jgyro.gyro_noise_rotation(key, sigma, (256,), jnp.float64, mod_quirk)
    noise = jax.random.normal(key, (256, 3), jnp.float64)
    monkeypatch.setattr(gyro, "noise_draw", lambda g, shape, dtype, device: _t(noise))
    tR = gyro_noise_rotation(torch.Generator(), sigma, (256,), torch.float64, mod_quirk, "cpu")
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-12)
    R0 = np.broadcast_to(np.eye(3), (256, 3, 3)) @ np.asarray(
        jgyro.gyro_noise_rotation(jax.random.key(5), 3.0, (256,), jnp.float64))
    jP = jgyro.perturb_attitude(key, jnp.asarray(R0), sigma, mod_quirk)
    tP = perturb_attitude(torch.Generator(), torch.from_numpy(R0.copy()), sigma, mod_quirk)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), atol=1e-12)


def test_gyro_mod_quirk_wraps_degrees():
    g = torch.Generator().manual_seed(0)
    R = gyro_noise_rotation(g, 200.0, (256,), torch.float64, True, "cpu")
    ang = np.degrees(np.arccos(np.clip((np.trace(R.numpy(), axis1=-2, axis2=-1) - 1) / 2, -1, 1)))
    assert ang.max() < 15.0  # 3 axes × ≤2π° each
    assert (gyro.mod_two_pi(torch.tensor([-1.0, 7.0], dtype=torch.float64)).numpy()
            == np.asarray(jnp.mod(jnp.asarray([-1.0, 7.0]), 2.0 * jnp.pi))).all()


# ---------------------------------------------------------------------------
# IMU
# ---------------------------------------------------------------------------


def _drone_pair(att_mode):
    """A float64 bank of 16 drones a few steps into a flight (rates,
    acceleration and attitude all non-trivial), in both packages."""
    jp = JP(att_mode=att_mode)
    rng = np.random.default_rng(4)
    js = jax.vmap(lambda p, y: j_drone_reset(jp, p, jnp.zeros(3), y))(
        jnp.asarray(rng.uniform(5, 10, (16, 3))), jnp.asarray(rng.uniform(-30, 30, (16, 3))))
    world = j_empty_world(ground=True, dtype=jnp.float64)
    act = jnp.asarray(rng.uniform(-0.5, 0.5, (16, 4)))
    for _ in range(3):
        js, _ = j_drone_step(jp, js, act, world)
    return jp, TP(att_mode=att_mode), js, interop.drone_state_from_numpy(
        interop.to_numpy_tree(js), "cpu")


@pytest.mark.parametrize("att_mode", ["rotmat", "quat"])
@pytest.mark.parametrize("noisy", [False, True])
def test_imu_matches_jax(att_mode, noisy, monkeypatch):
    """``imu_vectors`` and ``imu_observation`` from the same state, the
    accel draw before the gyro's as JAX splits ``ka, kg``."""
    jp, tp, js, ts = _drone_pair(att_mode)
    keys = jax.random.split(jax.random.key(9), 16)
    std = dict(accel_noise_std=0.3, gyro_noise_std_deg=1.0) if noisy else {}

    def draws(k):
        ka, kg = jax.random.split(k)
        return jax.random.normal(ka, (3,), jnp.float64), jax.random.normal(kg, (3,), jnp.float64)

    na, ng = jax.vmap(draws)(keys)
    monkeypatch.setattr(imu, "imu_noise", lambda g, shape, dtype, device: (_t(na), _t(ng)))
    gen = torch.Generator() if noisy else None
    want = jax.vmap(lambda s, k: jimu.imu_vectors(jp, s, k if noisy else None, **std))(js, keys)
    got = imu.imu_vectors(tp, ts, gen, **std)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-12)
    jobs = jax.vmap(lambda s, k: jimu.imu_observation(jp, s, k if noisy else None, **std))(
        js, keys)
    tobs = imu_observation(tp, ts, gen, **std)
    for f in ("world_from_body_T", "gyro_matrix", "accel_body"):
        np.testing.assert_allclose(getattr(tobs, f).numpy(), np.asarray(getattr(jobs, f)),
                                   atol=1e-12)
