"""Torque-based racer quad, the reference's second vehicle model (mirrors
``fpyv_tpu.physics.racer``).

Parity with tests/racer_drone_test.py:68-103 (``Racer``): rate control via
torque PIDs and a moment of inertia instead of direct rate low-passing:

- radius r = (prop_inch/2)·2.54/100, mass 0.5 kg, inertia I = m·r²
  (:70,82-83);
- per-axis PID on the angular velocity against the commanded rates
  (:11-32): error = desired − actual (the opposite sign of the main
  Drone's PID), integral without leak, raw derivative;
- ω ← ω + τ·dt/I (:98);
- attitude ← R @ E_intrinsic_XYZ(ω) (:99): scipy's ``from_euler("XYZ", ω)``
  of the RAW angular velocity (not ω·dt — a reference quirk, kept):
  R_step = Rx(ω₀) @ Ry(ω₁) @ Rz(ω₂);
- force = action₃ · R[:, 2]; v ← 0.9·v + a·dt (the 0.9 velocity damping
  quirk, :102); p ← p + v·dt (:103).

State fields batch over leading dims; the rotation chain is the
elementwise float32 one of :mod:`fpyv_tpu_torch.ops.rotations`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.ops import rotations as rot


@dataclass(frozen=True)
class RacerParams:
    prop_size_inch: float = 5.0
    mass: float = 0.5  # racer_drone_test.py:82
    dt: float = 1e-3  # :8
    velocity_damping: float = 0.9  # :102
    pid_roll: Tuple[float, float, float] = (2.0, 0.0, 0.0)  # :113
    pid_pitch: Tuple[float, float, float] = (2.0, 0.0, 0.0)
    pid_yaw: Tuple[float, float, float] = (0.1, 0.0, 0.0)

    @property
    def radius(self) -> float:
        return (self.prop_size_inch / 2.0) * 2.54 / 100.0

    @property
    def inertia(self) -> float:
        return self.mass * self.radius ** 2


@dataclass
class RacerState:
    pos: torch.Tensor  # (..., 3)
    vel: torch.Tensor  # (..., 3)
    R: torch.Tensor  # (..., 3, 3)
    omega: torch.Tensor  # (..., 3) angular velocity
    i_error: torch.Tensor  # (..., 3) PID integral
    last_error: torch.Tensor  # (..., 3)
    is_first: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "RacerState":
        return dataclasses.replace(self, **changes)


def racer_reset(batch_shape=(), dtype=torch.float32, device=None) -> RacerState:
    """racer_drone_test.py:85-93, on ``device`` (CUDA unless told)."""
    batch_shape = tuple(batch_shape)
    kw = dict(dtype=dtype, device=resolve_device(device))
    z3 = torch.zeros(batch_shape + (3,), **kw)
    return RacerState(pos=z3, vel=z3.clone(),
                      R=torch.eye(3, **kw).expand(batch_shape + (3, 3)).clone(),
                      omega=z3.clone(), i_error=z3.clone(), last_error=z3.clone(),
                      is_first=torch.ones(batch_shape, dtype=torch.bool, device=kw["device"]))


def _intrinsic_xyz(angles: torch.Tensor) -> torch.Tensor:
    """scipy ``from_euler("XYZ", a)``: Rx(a0) @ Ry(a1) @ Rz(a2)."""
    return rot.mat3_mul(rot.mat3_mul(rot.rotmat_x(angles[..., 0]), rot.rotmat_y(angles[..., 1])),
                        rot.rotmat_z(angles[..., 2]))


def racer_step(params: RacerParams, state: RacerState, action: torch.Tensor) -> RacerState:
    """action (..., 4): [roll_rate, pitch_rate, yaw_rate, thrust]."""
    dt = params.dt
    action = torch.as_tensor(action, dtype=state.omega.dtype, device=state.omega.device)
    gains = torch.tensor([params.pid_roll, params.pid_pitch, params.pid_yaw],
                         dtype=state.omega.dtype, device=state.omega.device)
    # (3, 3): rows per axis, columns [kP, kI, kD]

    # per-axis torque PID (racer_drone_test.py:22-32,96)
    error = action[..., :3] - state.omega
    i_error = state.i_error + error * dt
    d_error = torch.where(state.is_first[..., None], torch.zeros_like(error),
                          (error - state.last_error) / dt)
    torque = gains[:, 0] * error + gains[:, 1] * i_error + gains[:, 2] * d_error

    omega = state.omega + torque * dt / params.inertia  # :98
    R = rot.mat3_mul(state.R, _intrinsic_xyz(omega))  # :99 (raw ω as angles)
    force = action[..., 3:4] * R[..., :, 2]  # :100
    accel = force / params.mass
    vel = params.velocity_damping * state.vel + accel * dt  # :102
    pos = state.pos + vel * dt  # :103
    return RacerState(pos=pos, vel=vel, R=R, omega=omega, i_error=i_error, last_error=error,
                      is_first=torch.zeros_like(state.is_first))
