"""Barometric altimeter: pressure <-> altitude, noise, peak detection
(mirrors ``fpyv_tpu.sensors.baro``).

Reference parity:

- altitude from pressure (tests/height_pressure_calculator.py:4-9):
  ``h = ln(p0/p) · RT/(gM) + h0`` with g=9.80665, M=0.0289644 kg/mol,
  R=8.31432 J/(mol·K), T in Kelvin;
- ``pressure_from_altitude`` is its exact inverse (to *simulate* the
  sensor from the true height);
- ``quadratic_fit_reference`` ports tests/baro_max_altitude_test01.py:5-32
  (``second_order_fit``), whose iteration is a fixed point after one pass;
- ``is_peak_altitude`` ports the detector (:34-57): a peak once
  ``patience`` consecutive samples set no new maximum while the sample
  falls below the quadratic fit's prediction.

The pressure noise comes from a ``torch.Generator`` through
:func:`pressure_noise`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from fpyv_tpu_torch.ops.poly import quadratic_fit

G0 = 9.80665  # m/s^2 (height_pressure_calculator.py:5)
M_AIR = 0.0289644  # kg/mol
R_GAS = 8.31432  # J/(mol K)


@dataclass(frozen=True)
class BaroParams:
    init_pressure: float = 101325.0  # Pa
    init_height: float = 0.0  # m
    temperature_c: float = 20.0
    noise_std: float = 0.0  # Pa

    @property
    def scale_height(self) -> float:
        T = self.temperature_c + 273.15
        return R_GAS * T / (G0 * M_AIR)


def altitude_from_pressure(pressure, params: BaroParams = BaroParams()):
    """h = ln(p0/p)·RT/(gM) + h0 (height_pressure_calculator.py:4-9)."""
    return torch.log(params.init_pressure / torch.as_tensor(pressure)) * params.scale_height \
        + params.init_height


def pressure_from_altitude(height, params: BaroParams = BaroParams()):
    """Exact inverse of :func:`altitude_from_pressure`."""
    return params.init_pressure * torch.exp(
        -(torch.as_tensor(height) - params.init_height) / params.scale_height)


def pressure_noise(generator: torch.Generator, batch_shape, dtype, device) -> torch.Tensor:
    """The pressure noise's standard normal draw, (*batch_shape)."""
    return torch.randn(tuple(batch_shape), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def baro_measure(height, generator: Optional[torch.Generator] = None,
                 params: BaroParams = BaroParams(), part=None):
    """A barometric altitude reading from the true height: height ->
    pressure -> (+ Gaussian pressure noise) -> estimated altitude. Under
    ``part`` (an :class:`~fpyv_tpu_torch.envs.base.Part`) the noise is
    drawn for the whole bank and sliced."""
    p = pressure_from_altitude(height, params)
    if generator is not None and params.noise_std > 0.0:
        # imported here: the envs package imports the sensors
        from fpyv_tpu_torch.envs.base import draw_shape, take_part

        p = p + params.noise_std * take_part(
            pressure_noise(generator, draw_shape(p.shape, part), p.dtype, p.device), part)
    return altitude_from_pressure(p, params)


def quadratic_fit_reference(x, y):
    """Port of second_order_fit (baro_max_altitude_test01.py:5-32).

    The reference's normal equations are ad hoc (a and b share a
    denominator, and ``c`` pairs ``a`` with the mean and ``b`` with its
    square), and its iteration is a no-op after the first pass; this is
    exactly that first pass, kept as it is. Returns (a, b, c, r_squared).
    For a correct quadratic fit use :func:`fpyv_tpu_torch.ops.poly.quadratic_fit`.
    """
    y = torch.as_tensor(y)
    x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    xm = x.mean(-1, keepdim=True)
    denom = ((x - xm) ** 2).sum(-1)
    a = ((x - xm) ** 2 * y).sum(-1) / denom
    b = ((x - xm) * y).sum(-1) / denom
    ym = y.mean(-1)
    c = ym - a * xm[..., 0] - b * xm[..., 0] ** 2
    pred = a[..., None] * x ** 2 + b[..., None] * x + c[..., None]
    rss = ((y - pred) ** 2).sum(-1)
    tss = ((y - ym[..., None]) ** 2).sum(-1)
    return a, b, c, 1.0 - rss / tss


def is_peak_altitude(time, measurements, patience: int = 3,
                     use_reference_fit: bool = True) -> torch.Tensor:
    """Peak-altitude detector (baro_max_altitude_test01.py:34-57), (...,)
    bool over the series' leading dims.

    JAX scans the series with a running maximum and a counter of samples
    that set no new maximum; its carry starts at sample 0 and the scan
    visits sample 0 again, so the counter there is already 1. Written out
    over the whole series: with ``j`` the last index ``>= 1`` whose sample
    beats every earlier one (strictly), the counter at ``i`` is ``i - j``,
    and ``i + 1`` before any such ``j``. A peak is found where the counter
    reaches ``patience`` and the sample lies below the fit's prediction.
    """
    measurements = torch.as_tensor(measurements)
    time = torch.as_tensor(time, dtype=measurements.dtype, device=measurements.device)
    if use_reference_fit:
        a, b, c, _ = quadratic_fit_reference(time, measurements)
    else:
        coef = quadratic_fit(time, measurements)
        a, b, c = coef[..., 0], coef[..., 1], coef[..., 2]
    expected = a[..., None] * time ** 2 + b[..., None] * time + c[..., None]
    T = measurements.shape[-1]
    prev_max = torch.cummax(measurements, dim=-1).values[..., :-1]
    new_max = torch.cat([torch.zeros_like(measurements[..., :1], dtype=torch.bool),
                         measurements[..., 1:] > prev_max], dim=-1)
    idx = torch.arange(T, device=measurements.device)
    last = torch.cummax(torch.where(new_max, idx, -1), dim=-1).values
    counter = (idx - last).to(torch.int32)
    return ((counter >= patience) & (measurements < expected)).any(-1)
