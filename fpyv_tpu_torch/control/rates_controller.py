"""Attitude -> body-rates controller, the acro "rates PID" loop (mirrors
``fpyv_tpu.control.rates_controller``).

Reference parity (tests/rotation_pid.py:100-139 ``RotationRatesController``):

- low-pass the *Euler angles* of the current state, the goal, and the error
  (transition coefficients for state/goal/error),
- relative rotation ``R_rel = R_goalᵀ @ R_current``,
- rates = clip(gain · rad2deg(euler(R_rel)), ±max_rates).

The controller behind the BASELINE "rates-PID hover" config. State is
three 3-vectors; everything batches over leading dims, and the products
are the elementwise float32 ones of :mod:`fpyv_tpu_torch.ops.rotations`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.ops import rotations as rot


@dataclass(frozen=True)
class RatesControllerParams:
    gain: float = 30.0
    max_rates: float = 480.0  # deg/s (rotation_pid.py:146)
    state_transition_coef: float = 0.75  # rotation_pid.py:150
    goal_transition_coef: float = 0.9
    error_transition_coef: float = 0.9


@dataclass
class RatesControllerState:
    prev_state: torch.Tensor  # (..., 3) low-passed Euler of the current attitude
    prev_goal: torch.Tensor  # (..., 3)
    prev_error: torch.Tensor  # (..., 3)

    def replace(self, **changes) -> "RatesControllerState":
        return dataclasses.replace(self, **changes)


def rates_controller_init(batch_shape=(), dtype=torch.float32,
                          device=None) -> RatesControllerState:
    """Zeroed memories on ``device`` (CUDA unless told)."""
    z = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=resolve_device(device))
    return RatesControllerState(prev_state=z, prev_goal=z.clone(), prev_error=z.clone())


def rates_controller_step(params: RatesControllerParams, state: RatesControllerState,
                          R_current: torch.Tensor, R_goal: torch.Tensor):
    """Returns (new_state, rates_deg, error_euler). Parity: rotation_pid.py:122-139."""
    a_s, a_g, a_e = (params.state_transition_coef, params.goal_transition_coef,
                     params.error_transition_coef)
    euler_state = a_s * rot.rotmat_to_euler(R_current) + (1 - a_s) * state.prev_state
    R_c = rot.euler_to_rotmat(euler_state)
    euler_goal = a_g * rot.rotmat_to_euler(R_goal) + (1 - a_g) * state.prev_goal
    R_g = rot.euler_to_rotmat(euler_goal)
    R_rel = rot.mat3_mul(R_g.transpose(-1, -2), R_c)  # rotation_pid.py:130
    euler_error = a_e * rot.rotmat_to_euler(R_rel) + (1 - a_e) * state.prev_error
    rates = torch.clamp(params.gain * torch.rad2deg(euler_error),
                        -params.max_rates, params.max_rates)
    new_state = RatesControllerState(prev_state=euler_state, prev_goal=euler_goal,
                                     prev_error=euler_error)
    return new_state, rates, euler_error
