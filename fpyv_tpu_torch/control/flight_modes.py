"""Self-level flight modes: ANGLE and HORIZON on top of the acro stack
(mirrors ``fpyv_tpu.control.flight_modes``).

The reference flies acro only (rates sticks, components.py:179-196); these
are the standard self-level modes FPV firmware layers on the same rates
loop (Betaflight-style semantics):

- **ANGLE**: roll/pitch sticks command *attitude angles* (stick x
  max_angle); the yaw stick stays a rate. The reference-parity rates
  controller (:mod:`fpyv_tpu_torch.control.rates_controller`) turns the
  attitude error into body rates.
- **HORIZON**: blends ANGLE and acro per step — self-level at stick
  center, raw acro rates at full deflection; blend = max(|roll|, |pitch|).

Both return an *acro-compatible action* (..., 4) for anything built on
``drone_step``: the rate channels encode the commanded rates through the
drone's own mapping ``rates_cmd = clip(-action[:3] * max_rates)``
(components.py:185 — note the negation); throttle passes through.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field

import torch

from fpyv_tpu_torch.control.rates_controller import (
    RatesControllerParams,
    RatesControllerState,
    rates_controller_init,
    rates_controller_step,
)
from fpyv_tpu_torch.ops import rotations as rot


@dataclass(frozen=True)
class FlightModeParams:
    max_angle_deg: float = 45.0  # full stick = this roll/pitch angle
    max_yaw_rate: float = 200.0  # deg/s, the yaw stick stays a rate in ANGLE
    max_rates: float = 200.0  # acro rates ceiling (params.yaml max_rates)
    controller: RatesControllerParams = field(
        default_factory=lambda: RatesControllerParams(
            gain=8.0, max_rates=200.0,
            # self-level wants a crisper loop than the hover demo tuning
            state_transition_coef=1.0, goal_transition_coef=1.0,
            error_transition_coef=1.0))


@dataclass
class FlightModeState:
    controller: RatesControllerState

    def replace(self, **changes) -> "FlightModeState":
        return dataclasses.replace(self, **changes)


def flight_mode_init(batch_shape=(), dtype=torch.float32, device=None) -> FlightModeState:
    """Zeroed controller memories on ``device`` (CUDA unless told)."""
    return FlightModeState(controller=rates_controller_init(batch_shape, dtype, device))


def rates_to_action(rates_deg: torch.Tensor, max_rates: float) -> torch.Tensor:
    """Invert the drone's ``rates_cmd = -action * max_rates`` mapping
    (components.py:185) so commanded rates survive action2force exactly
    (up to the low-pass)."""
    return torch.clamp(-rates_deg / max_rates, -1.0, 1.0)


def _level_rates(params: FlightModeParams, state: FlightModeState,
                 R_current: torch.Tensor, sticks: torch.Tensor):
    """Body rates (deg/s) that drive the attitude toward the stick-commanded
    roll/pitch at the current yaw. sticks: (..., 4) acro layout."""
    euler = rot.rotmat_to_euler(R_current)  # (..., 3) roll, pitch, yaw
    max_angle = math.radians(params.max_angle_deg)
    # acro +stick nets a POSITIVE angle (the action negation and the
    # transposed rotation composition cancel), so the self-level target
    # keeps that sign and mode switches don't flip the airframe
    goal = torch.stack([sticks[..., 0] * max_angle, sticks[..., 1] * max_angle,
                        euler[..., 2]], dim=-1)
    ctrl, rates, _err = rates_controller_step(params.controller, state.controller, R_current,
                                              rot.euler_to_rotmat(goal))
    # yaw stays a rate channel with acro's sign convention (a new tensor:
    # the controller's output is not written in place)
    rates = torch.cat([rates[..., :2], (-sticks[..., 2] * params.max_yaw_rate)[..., None]],
                      dim=-1)
    return FlightModeState(controller=ctrl), rates


def angle_mode_action(params: FlightModeParams, state: FlightModeState,
                      R_current: torch.Tensor, sticks: torch.Tensor):
    """ANGLE mode: returns (state, acro_action) — sticks command angles.
    R_current (..., 3, 3); sticks (..., 4) [roll, pitch, yaw, throttle] in
    [-1, 1]."""
    state, rates = _level_rates(params, state, R_current, sticks)
    action = torch.cat([rates_to_action(rates, params.max_rates), sticks[..., 3:4]], dim=-1)
    return state, action


def horizon_mode_action(params: FlightModeParams, state: FlightModeState,
                        R_current: torch.Tensor, sticks: torch.Tensor):
    """HORIZON mode: returns (state, acro_action) — self-level at center
    stick, pure acro at full deflection."""
    state, level_rates = _level_rates(params, state, R_current, sticks)
    level_part = rates_to_action(level_rates, params.max_rates)
    blend = torch.clamp(torch.maximum(sticks[..., 0].abs(), sticks[..., 1].abs()),
                        0.0, 1.0)[..., None]
    mixed = blend * sticks[..., :3] + (1.0 - blend) * level_part
    return state, torch.cat([mixed, sticks[..., 3:4]], dim=-1)
