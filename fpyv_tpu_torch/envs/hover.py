"""Hover env + rates-PID pilot: BASELINE config #1 (mirrors
``fpyv_tpu.envs.hover``).

"single drone, rates-PID hover, state-vector obs, fixed seed" — the drone
must hold a target position. The scripted :class:`HoverPilot` closes the
loop the way the reference's rotation_pid.py main does: the
RotationRatesController turns the attitude error into body-rate commands
(rates/max_rates as the action's first three channels, with the sign flip
the drone's action mapping expects), while a PID on the altitude drives
the throttle through the thrust curve's inverse.

As the port's ``AcroEnv``, the batch dimension is written out and the
draws come from a ``torch.Generator`` through :func:`reset_draws`; the
state has no ``key`` field. As JAX's env, every step draws a fresh reset
for every env and keeps it where the env is done.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.control.pid import PidParams, PidState, pid_init, pid_step
from fpyv_tpu_torch.control.rates_controller import (
    RatesControllerParams,
    RatesControllerState,
    rates_controller_init,
    rates_controller_step,
)
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.physics.drone import (
    DroneParams,
    DroneState,
    _att_to_rotmat,
    drone_reset,
    drone_step,
)
from fpyv_tpu_torch.physics.world import World, empty_world


@dataclass
class HoverState:
    drone: DroneState
    target_pos: torch.Tensor  # (..., 3)
    t: torch.Tensor  # (...,) int32

    def replace(self, **changes) -> "HoverState":
        return dataclasses.replace(self, **changes)


def reset_draws(generator: torch.Generator, batch_shape, spawn_height, dtype, device):
    """A reset's draws: the target's height U(spawn_height), (*batch_shape),
    then the spawn jitter's standard normal, (*batch_shape, 3)."""
    shape = tuple(batch_shape)
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    n = torch.randn(shape + (3,), generator=generator, dtype=dtype, device=generator.device)
    lo, hi = spawn_height
    return (u * (hi - lo) + lo).to(device), n.to(device)


@dataclass(frozen=True)
class HoverEnv:
    params: DroneParams = field(default_factory=DroneParams)
    spawn_height: Tuple[float, float] = (4.0, 12.0)
    spawn_jitter: float = 2.0
    max_episode_steps: int = 1000
    pos_tolerance: float = 0.25
    dtype: torch.dtype = torch.float32

    def default_world(self, device=None) -> World:
        """Ground only, on ``device`` (CUDA unless told)."""
        return empty_world(ground=True, dtype=self.dtype, device=device)

    @property
    def obs_dim(self) -> int:
        att = 9 if self.params.att_mode == "rotmat" else 4
        return 3 + 3 + att + 3 + 1

    def _obs(self, state: HoverState) -> torch.Tensor:
        d = state.drone
        att = d.att.reshape(d.att.shape[:-2] + (9,)) if self.params.att_mode == "rotmat" else d.att
        return torch.cat([state.target_pos - d.pos, d.vel, att,
                          d.rates / self.params.max_rates,
                          d.thrust[..., None] / self.params.thrust_curve.max_force],
                         dim=-1).to(self.dtype)

    def reset(self, generator: torch.Generator, batch_shape=(), device=None,
              part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs on ``device`` (CUDA unless
        told) and its observation: the target straight above the origin at
        a random height, the drone jittered around it (at least 1 m up),
        level and at rest. Under ``part`` the draws are made at the whole
        bank's shape and sliced."""
        device = resolve_device(device)
        batch_shape = tuple(batch_shape)
        height, n = take_part(reset_draws(generator, draw_shape(batch_shape, part),
                                          self.spawn_height, self.dtype, device), part)
        zero = torch.zeros_like(height)
        target = torch.stack([zero, zero, height], dim=-1)
        pos = target + self.spawn_jitter * n
        pos = torch.cat([pos[..., :2], torch.clamp_min(pos[..., 2:], 1.0)], dim=-1)
        zeros3 = torch.zeros_like(pos)
        drone = drone_reset(self.params, pos, zeros3, zeros3)
        state = HoverState(drone=drone, target_pos=target,
                           t=torch.zeros(batch_shape, dtype=torch.int32, device=device))
        return state, self._obs(state)

    def step(self, state: HoverState, action, world: Optional[World] = None,
             generator: Optional[torch.Generator] = None, part: Optional[Part] = None):
        """Returns (state, obs, reward, done, info). Every step draws a reset
        for every env from ``generator`` (the default generator of the
        state's device when None), kept where the env crashed or reached
        ``max_episode_steps``."""
        device = state.drone.pos.device
        world = self.default_world(device) if world is None else world
        generator = default_generator(device) if generator is None else generator
        action = torch.as_tensor(action, dtype=self.dtype, device=device)
        drone, _ = drone_step(self.params, state.drone, action, world)
        err = torch.linalg.vector_norm(state.target_pos - drone.pos, dim=-1)
        reward = (-err - 10.0 * drone.done.to(self.dtype)
                  + (err < self.pos_tolerance).to(self.dtype))
        t = state.t + 1
        done = drone.done | (t >= self.max_episode_steps)
        reset_state, _ = self.reset(generator, tuple(t.shape), device, part)
        next_state = tree_where(done, reset_state, state.replace(drone=drone, t=t))
        return next_state, self._obs(next_state), reward, done, {"pos_err": err}


# ---------------------------------------------------------------------------
# Scripted rates-PID hover pilot
# ---------------------------------------------------------------------------


@dataclass
class HoverPilotState:
    rates: RatesControllerState
    alt_pid: PidState

    def replace(self, **changes) -> "HoverPilotState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class HoverPilot:
    """Attitude via RotationRatesController + altitude via PID -> acro action."""

    drone_params: DroneParams
    rates: RatesControllerParams = field(
        default_factory=lambda: RatesControllerParams(gain=8.0, max_rates=200.0))
    # the PID outputs a thrust in Newtons around hover
    alt_pid: PidParams = field(default_factory=lambda: PidParams(
        kP=6.0, kI=2.0, kD=3.0, dt=1 / 60, integral_clip=5.0,
        min_output=1.0, max_output=28.0, derivative_transition_rate=0.5))

    def init(self, batch_shape=(), dtype=torch.float32, device=None) -> HoverPilotState:
        """Zeroed controllers on ``device`` (CUDA unless told)."""
        return HoverPilotState(rates=rates_controller_init(batch_shape, dtype, device),
                               alt_pid=pid_init(batch_shape, dtype, device))

    def act(self, pstate: HoverPilotState, drone: DroneState, target_pos: torch.Tensor):
        p = self.drone_params
        R = _att_to_rotmat(p, drone.att)
        # goal attitude: level, tilted slightly toward the lateral error
        lateral = torch.clamp(target_pos[..., :2] - drone.pos[..., :2]
                              - 0.8 * drone.vel[..., :2], -3.0, 3.0)
        # desired roll/pitch (small angles): pitch toward +x err, roll toward -y err
        pitch = torch.clamp(0.08 * lateral[..., 0], -0.35, 0.35)
        roll = torch.clamp(-0.08 * lateral[..., 1], -0.35, 0.35)
        R_goal = rot.euler_to_rotmat(torch.stack([roll, pitch, torch.zeros_like(roll)], dim=-1))
        rstate, rates_cmd, _ = rates_controller_step(self.rates, pstate.rates, R, R_goal)
        # the drone negates action[:3] (components.py:185): feed -rates/max
        act_rates = -rates_cmd / p.max_rates
        # altitude: the PID's arguments in JAX's order, the target in the
        # ``current`` slot, so its error is target - position and the thrust
        # rises below the target (pid_step's own error is current - target)
        alt_state, thrust_n = pid_step(self.alt_pid, pstate.alt_pid,
                                       target_pos[..., 2], drone.pos[..., 2])
        throttle = p.thrust_curve.thrust_to_throttle(thrust_n)
        action = torch.cat([act_rates, throttle[..., None]], dim=-1)
        return HoverPilotState(rates=rstate, alt_pid=alt_state), action
