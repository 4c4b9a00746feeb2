"""Motor/thrust model: throttle <-> thrust from bench-test data, battery math
(mirrors ``fpyv_tpu.physics.motor``).

Reference parity (src/utils/components.py:128-144, flight_time_calculator.py):

- total thrust (N) = n_motors * thrust_grams / 1000 * g  (components.py:134)
- ``throttle2thrust(x)``: degree-3 polyfit of (throttle%, thrust_N) with the
  origin sample (0,0) prepended, evaluated at ``100*(x+1)/2`` for x in [-1,1]
  (components.py:136, flight_time_calculator.py:43-52).
- ``thrust2throttle(F)``: a *separate* degree-3 polyfit of (thrust_N,
  throttle%), output mapped ``/100*2-1`` and clipped to [-1,1]
  (components.py:137).
- force floor/ceiling: poly evaluated at 5% and 100% throttle
  (components.py:139-144); the floor must be positive.

Fits run on the host in float64 once at config time; the step evaluates the
baked coefficients with a Horner chain (fpyv_tpu_torch.ops.poly.polyval).

The default bench tables below are the F80 test report's five motor-variant
blocks (throttle 50..100% in 5% steps; single-motor thrust in grams), as
parsed by :func:`fpyv_tpu_torch.io.motor_csv.read_motor_test_report`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fpyv_tpu_torch.ops.poly import fit_poly_through_origin, polyval

# T-Motor F80 bench data: (motor name, propeller, throttle %, single-motor thrust g).
# Same numbers config/t_motos_f80_motor_test.csv carries; baked so the framework
# is standalone, while any CSV path can override via `fit_thrust_curve_from_csv`.
_F80_THROTTLE = np.arange(50.0, 101.0, 5.0)
F80_BENCH_TABLES: Tuple[Tuple[str, str, np.ndarray], ...] = (
    ("F80 Pro KV1900", "5055 Tri-Blade",
     np.array([790.04, 908.12, 1042.01, 1182.98, 1323.01, 1418.16, 1555.57,
               1683.97, 1793.47, 1896.57, 2114.78])),
    ("F80 Pro", "5055 Tri-Blade",
     np.array([704.65, 818.27, 907.14, 1031.42, 1154.17, 1287.66, 1388.59,
               1492.02, 1589.63, 1661.82, 1867.94])),
    ("KV2200", "6040 2-Blade",
     np.array([736.57, 847.93, 993.47, 1110.80, 1239.35, 1396.62, 1540.87,
               1661.79, 1741.02, 1851.99, 2037.30])),
    ("F80 Pro", "5055 Tri-Blade",
     np.array([591.73, 676.24, 751.15, 843.19, 945.44, 1010.05, 1120.09,
               1222.90, 1304.56, 1363.42, 1516.82])),
    ("KV2500", "6040 2-Blade",
     np.array([625.57, 719.71, 816.18, 917.09, 1004.55, 1106.85, 1228.74,
               1320.52, 1419.87, 1527.30, 1700.76])),
)

MIN_THROTTLE_PERCENT = 5.0  # components.py:139


@dataclass(frozen=True)
class ThrustCurve:
    """Baked throttle<->thrust polynomials (static, hashable params)."""

    throttle2thrust_coeffs: Tuple[float, ...]  # highest-degree-first, x = throttle %
    thrust2throttle_coeffs: Tuple[float, ...]  # highest-degree-first, x = thrust N
    min_force: float  # N at 5% throttle (components.py:140)
    max_force: float  # N at 100% throttle (components.py:142)
    motor_name: str = ""
    propeller: str = ""

    def throttle_to_thrust(self, x):
        """x in [-1, 1] -> total thrust in Newtons (components.py:136)."""
        return polyval(np.asarray(self.throttle2thrust_coeffs), 100.0 * (x + 1.0) / 2.0)

    def thrust_to_throttle(self, force):
        """thrust N -> throttle in [-1, 1], clipped (components.py:137)."""
        return torch.clamp(
            polyval(np.asarray(self.thrust2throttle_coeffs), force) / 100.0 * 2.0 - 1.0,
            -1.0,
            1.0,
        )


def fit_thrust_curve(
    throttle_pct: np.ndarray,
    thrust_g: np.ndarray,
    n_motors: int = 4,
    gravity: float = 9.81,
    motor_name: str = "",
    propeller: str = "",
) -> ThrustCurve:
    """Fit both polynomials from one bench block (host, float64)."""
    thrust_n = n_motors * np.asarray(thrust_g, np.float64) / 1000.0 * gravity
    fwd = fit_poly_through_origin(throttle_pct, thrust_n, degree=3, origin=True)
    inv = fit_poly_through_origin(thrust_n, throttle_pct, degree=3, origin=True)
    min_force = float(np.polyval(fwd, MIN_THROTTLE_PERCENT))
    max_force = float(np.polyval(fwd, 100.0))
    if min_force <= 0:
        raise ValueError(
            "The minimum throttle maps to non-positive force"  # components.py:141
            f" ({min_force:.4f} N at {MIN_THROTTLE_PERCENT}% throttle)"
        )
    return ThrustCurve(
        throttle2thrust_coeffs=tuple(float(c) for c in fwd),
        thrust2throttle_coeffs=tuple(float(c) for c in inv),
        min_force=min_force,
        max_force=max_force,
        motor_name=motor_name,
        propeller=propeller,
    )


def default_thrust_curve(
    idx: int = 0, n_motors: int = 4, gravity: float = 9.81
) -> ThrustCurve:
    """Thrust curve from the baked F80 tables (``motor_test_report_idx`` parity)."""
    name, prop, thrust_g = F80_BENCH_TABLES[idx]
    return fit_thrust_curve(
        _F80_THROTTLE, thrust_g, n_motors, gravity, motor_name=name, propeller=prop
    )


def thrust_curve_from_csv(
    path, idx: int = 0, n_motors: int = 4, gravity: float = 9.81
) -> ThrustCurve:
    """Thrust curve from a motor bench CSV (same schema as the T-Motor reports)."""
    from fpyv_tpu_torch.io.motor_csv import read_motor_test_report

    block = read_motor_test_report(path)[idx]
    return fit_thrust_curve(
        block.throttle,
        block.thrust_g,
        n_motors,
        gravity,
        motor_name=block.motor_name,
        propeller=block.propeller,
    )


# ---------------------------------------------------------------------------
# Battery / endurance math (flight_time_calculator.py:6-13, 55-145)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Battery:
    """Parity: flight_time_calculator.py:6-13."""

    cells: int
    capacity_mah: float
    mass_g: float

    @property
    def nominal_voltage(self) -> float:
        return self.cells * 3.7  # flight_time_calculator.py:143

    @property
    def power_wh(self) -> float:
        return self.nominal_voltage * self.capacity_mah / 1000.0


def power_from_thrust_model(thrust_g: np.ndarray, power_w: np.ndarray, degree: int = 3):
    """Power(thrust) polyfit with origin sample. Parity: flight_time_calculator.py:55-66."""
    return fit_poly_through_origin(thrust_g, power_w, degree=degree, origin=True)


def throttle_and_current_from_thrust(
    thrust_at_hover_g: float, thrust_g, throttle_pct, current_a, degree: int = 3
):
    """Hover throttle %% and total (4-motor) current draw.
    Parity: flight_time_calculator.py:69-82."""
    thr = np.polyval(
        fit_poly_through_origin(thrust_g, throttle_pct, degree=degree), thrust_at_hover_g
    )
    cur = 4.0 * np.polyval(
        fit_poly_through_origin(thrust_g, current_a, degree=degree), thrust_at_hover_g
    )
    return float(thr), float(cur)


def check_battery_cells(voltage_v: np.ndarray) -> int:
    """Estimate cell count from bench voltages. Parity: flight_time_calculator.py:118-125."""
    return int(np.floor(np.asarray(voltage_v, np.float64) / 3.8).mean())


def max_hover_time(
    dry_mass_g: float,
    battery: Battery,
    thrust_g: np.ndarray,
    power_w: np.ndarray,
    motor_mass_g: float,
) -> float:
    """Maximum hover time in minutes. Parity: flight_time_calculator.py:128-145."""
    total_mass = dry_mass_g + battery.mass_g + 4.0 * motor_mass_g
    thrust_needed_per_motor = total_mass / 4.0
    motor_model = power_from_thrust_model(thrust_g, power_w)
    motor_power = 4.0 * np.polyval(motor_model, thrust_needed_per_motor)
    return float(60.0 * battery.power_wh / motor_power)
