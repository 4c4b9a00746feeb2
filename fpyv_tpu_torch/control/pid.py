"""Vectorized scalar PID with leaky integral and low-pass-filtered
derivative (mirrors ``fpyv_tpu.control.pid``).

Reference parity (src/utils/components.py:15-54):

- error = current - target;
- leaky integral: ``I <- clip(0.99 I + e dt, ±integral_clip)``;
- derivative: ``clip((1 - is_first)(e - e_prev)/dt, -1, 1)``, low-passed
  ``d <- (1-α) d_prev + α d`` (derivative_transition_rate);
- output: ``clip(kP e + kI I + kD d, min_output, max_output)``.

State is fixed-size: one (...,)-shaped tensor per field.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fpyv_tpu_torch.device import resolve_device


@dataclass(frozen=True)
class PidParams:
    kP: float
    kI: float
    kD: float
    dt: float
    integral_clip: float = 1.0
    min_output: float = 0.3
    max_output: float = 1.0
    derivative_transition_rate: float = 0.5
    integral_leak: float = 0.99  # components.py:46


@dataclass
class PidState:
    error: torch.Tensor  # (...,)
    integral: torch.Tensor
    prev_derivative: torch.Tensor
    previous_error: torch.Tensor
    is_first: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "PidState":
        return dataclasses.replace(self, **changes)


def pid_init(batch_shape=(), dtype=torch.float32, device=None) -> PidState:
    """Zeroed controllers on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    z = torch.zeros(tuple(batch_shape), dtype=dtype, device=device)
    return PidState(error=z, integral=z.clone(), prev_derivative=z.clone(),
                    previous_error=z.clone(),
                    is_first=torch.ones(tuple(batch_shape), dtype=torch.bool, device=device))


def pid_step(params: PidParams, state: PidState, current, target):
    """Returns (new_state, output). Parity: components.py:43-54."""
    error = current - target
    integral = torch.clamp(params.integral_leak * state.integral + error * params.dt,
                           -params.integral_clip, params.integral_clip)
    raw_d = torch.clamp(
        torch.where(state.is_first, torch.zeros_like(error),
                    (error - state.previous_error) / params.dt),
        -1.0, 1.0)
    a = params.derivative_transition_rate
    derivative = (1.0 - a) * state.prev_derivative + a * raw_d
    out = torch.clamp(params.kP * error + params.kI * integral + params.kD * derivative,
                      params.min_output, params.max_output)
    new_state = PidState(error=error, integral=integral, prev_derivative=derivative,
                         previous_error=error, is_first=torch.zeros_like(state.is_first))
    return new_state, out
