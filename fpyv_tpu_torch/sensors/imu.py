"""IMU-style observation: what the reference's Drone.step returns (mirrors
``fpyv_tpu.sensors.imu``).

Parity (components.py:224-225,247-248): "IRL the drone doesn't know its
state: Only IMU measurements and orientation" — the observation is
``(Rᵀ, E(rates), R @ accel)`` with the deg/s-as-radians gyro quirk.

:func:`imu_vectors` is the shared noisy-measurement core (orientation,
noisy body rates, noisy body-frame acceleration), used by
:func:`imu_observation` (the reference's tuple) and by the sensor-obs env
(:mod:`fpyv_tpu_torch.envs.sensor_acro`). Its noise comes from a
``torch.Generator`` through :func:`imu_noise`: the accelerometer's draw
first, then the gyro's, as JAX splits its key ``ka, kg``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.physics.drone import DroneParams, DroneState, ImuObs, _att_to_rotmat


def imu_noise(generator: torch.Generator, batch_shape, dtype, device):
    """The accelerometer's and then the gyro's standard normal draws, each
    (*batch_shape, 3)."""
    shape = tuple(batch_shape) + (3,)
    accel = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    gyro = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    return accel.to(device), gyro.to(device)


def imu_vectors(params: DroneParams, state: DroneState,
                generator: Optional[torch.Generator] = None, accel_noise_std: float = 0.0,
                gyro_noise_std_deg: float = 0.0, part=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R (..., 3, 3), noisy rates deg/s (..., 3), noisy body accel (..., 3)).
    With a generator and a noise level above 0, both noises are drawn (the
    level 0 one is then unused); under ``part`` (an
    :class:`~fpyv_tpu_torch.envs.base.Part`) they are drawn for the whole
    bank and sliced."""
    R = _att_to_rotmat(params, state.att)
    rates = state.rates
    accel_body = rot.mat3_vec(R, state.accel)
    if generator is not None and (accel_noise_std > 0.0 or gyro_noise_std_deg > 0.0):
        # imported here: the envs package imports the sensors
        from fpyv_tpu_torch.envs.base import draw_shape, take_part

        na, ng = take_part(imu_noise(generator, draw_shape(rates.shape[:-1], part),
                                     rates.dtype, rates.device), part)
        if accel_noise_std > 0.0:
            accel_body = accel_body + accel_noise_std * na
        if gyro_noise_std_deg > 0.0:
            rates = rates + gyro_noise_std_deg * ng
    return R, rates, accel_body


def imu_observation(params: DroneParams, state: DroneState,
                    generator: Optional[torch.Generator] = None, accel_noise_std: float = 0.0,
                    gyro_noise_std_deg: float = 0.0, part=None) -> ImuObs:
    """The reference's step-return tuple, optionally with sensor noise."""
    R, rates, accel_body = imu_vectors(params, state, generator, accel_noise_std,
                                       gyro_noise_std_deg, part)
    return ImuObs(world_from_body_T=R.transpose(-1, -2),
                  gyro_matrix=rot.euler_to_rotmat(rates),  # deg/s-as-radians quirk
                  accel_body=accel_body)
