"""Sensor-model acro env: IMU + barometer + UWB observations (mirrors
``fpyv_tpu.envs.sensor_acro``).

BASELINE config #3: "sensor-model envs: gyro noise + baro altitude,
domain-randomized mass/drag/thrust". Wraps the acro env so the policy sees
only what a real FPV stack would (components.py:224-225: "IRL the drone
doesn't know its state: Only IMU measurements and orientation"):

- the IMU tuple (Rᵀ flattened, body acceleration) with accel noise,
- gyro rates with Gaussian noise (deg/s),
- the barometric altitude through the pressure model
  (:mod:`fpyv_tpu_torch.sensors.baro`) with pressure noise,
- the UWB range to the chased target, clamped to the sensor's maximum
  (components.py:287),
- the previous action (standard for partially observed control).

Domain randomization is the acro env's (``AcroEnv(randomize=True)``). As
the port's ``AcroEnv``, the batch dimension is written out and every draw
comes from one ``torch.Generator`` in JAX's order: the acro env's (reset,
or step and its auto-reset), then the observation's — IMU accel, IMU gyro,
baro, UWB (JAX's ``ki, kb, ku``) — each through its sensor's draw function.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

from fpyv_tpu_torch.envs.acro import AcroEnv, AcroState
from fpyv_tpu_torch.envs.base import Part, default_generator
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.sensors.baro import BaroParams, baro_measure
from fpyv_tpu_torch.sensors.imu import imu_vectors
from fpyv_tpu_torch.sensors.uwb import uwb_range


@dataclass
class SensorAcroState:
    acro: AcroState
    prev_action: torch.Tensor  # (..., 4)

    def replace(self, **changes) -> "SensorAcroState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class SensorAcroEnv:
    acro: AcroEnv = field(default_factory=lambda: AcroEnv(randomize=True))
    gyro_noise_std_deg: float = 1.0
    accel_noise_std: float = 0.3
    baro: BaroParams = field(default_factory=lambda: BaroParams(noise_std=5.0))
    uwb_max_range: float = 13.0
    uwb_noise_std: float = 0.05

    @property
    def obs_dim(self) -> int:
        # Rᵀ (9) + accel_body (3) + noisy rates (3) + baro alt (1)
        # + uwb range (1) + prev action (4)
        return 9 + 3 + 3 + 1 + 1 + 4

    def _obs(self, state: SensorAcroState, world: World, generator: torch.Generator,
             part: Optional[Part] = None) -> torch.Tensor:
        d = state.acro.drone
        R, rates, accel_body = imu_vectors(self.acro.params, d, generator,
                                           accel_noise_std=self.accel_noise_std,
                                           gyro_noise_std_deg=self.gyro_noise_std_deg, part=part)
        RT_flat = R.transpose(-1, -2).reshape(d.pos.shape[:-1] + (9,))
        alt = baro_measure(d.pos[..., 2], generator, self.baro, part)
        rng = uwb_range(d.pos, world.sphere_center[..., 0, :],
                        target_radius=world.sphere_radius[..., 0],
                        max_range=self.uwb_max_range, generator=generator,
                        noise_std=self.uwb_noise_std, part=part)
        return torch.cat([RT_flat, accel_body / 30.0, rates / self.acro.params.max_rates,
                          alt[..., None] / 20.0, rng[..., None] / self.uwb_max_range,
                          state.prev_action], dim=-1).to(self.acro.dtype)

    def reset(self, generator: torch.Generator, world: Optional[World] = None,
              batch_shape=(), device=None, part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs and its observation. Without
        a world, the acro env's default world is built on ``device`` (CUDA
        unless told). Under ``part`` the bank is one rank's slice of a
        larger bank: the draws are made at the whole bank's shape and
        sliced."""
        world = self.acro.default_world(device) if world is None else world
        acro_state, _ = self.acro.reset(generator, world, batch_shape, part=part)
        state = SensorAcroState(
            acro=acro_state,
            prev_action=torch.zeros(tuple(batch_shape) + (4,), dtype=self.acro.dtype,
                                    device=acro_state.drone.pos.device))
        return state, self._obs(state, world, generator, part)

    def step(self, state: SensorAcroState, action, world: Optional[World] = None,
             generator: Optional[torch.Generator] = None, part: Optional[Part] = None):
        """Returns (state, obs, reward, done, info): the acro env's step
        (its auto-reset drawn from ``generator``, the default generator of
        the state's device when None), then the new observation's draws."""
        device = state.acro.drone.pos.device
        world = self.acro.default_world(device) if world is None else world
        generator = default_generator(device) if generator is None else generator
        action = torch.as_tensor(action, dtype=self.acro.dtype, device=device)
        acro_state, _, reward, done, info = self.acro.step(state.acro, action, world,
                                                           generator=generator, part=part)
        # zero the action memory across auto-reset boundaries: a new episode's
        # first obs must not carry the crashed episode's terminal action
        prev_action = torch.where(done[..., None], torch.zeros_like(action), action)
        next_state = SensorAcroState(acro=acro_state, prev_action=prev_action)
        return next_state, self._obs(next_state, world, generator, part), reward, done, info
