"""The drone physics step (mirrors ``fpyv_tpu.physics.drone``).

One batch-agnostic function over tensors with arbitrary leading batch
dims, replicating the reference's ``Drone.step`` (components.py:220-248)
and its kinematics with every documented quirk:

1. action mapping: ``rates_cmd = clip(-a[:3] * max_rates)`` (NEGATED),
   first-order low-pass on rates and thrust, thrust from the bench cubic
   with the throttle clipped to [-1, 1];
2. guidance override of attitude and applied |F|, with the low-pass
   memories still tracking the action;
3. body-frame quadratic drag (rho = 1.2225) on velocity + wind;
4. collisions at the 4 motor points (:mod:`fpyv_tpu_torch.physics.collisions`);
5. semi-implicit Euler, POSITION FIRST;
6. the double rotation quirk (attitude advanced twice per step);
7. the IMU observation ``(R_newᵀ, E(rates), R_new @ accel)`` with E reading
   deg/s as radians.

Attitude modes: ``'rotmat'`` stores R (..., 3, 3); ``'quat'`` stores a unit
quaternion (..., 4) whose update composes the same per-axis Euler rotation.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.config import FpyvConfig
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.physics import collisions
from fpyv_tpu_torch.physics.motor import ThrustCurve, default_thrust_curve, thrust_curve_from_csv
from fpyv_tpu_torch.physics.world import World

AIR_DENSITY = 1.2225  # kg/m^3 at 20 C (kinematics.py:33-34)


def motor_layout(n_motors: int = 4, radius_in: float = 5.0) -> np.ndarray:
    """X-frame motor positions in the body frame (components.py:120-125):
    angles at 45°,135°,225°,315° on a circle of radius 5·2.54/100 m."""
    r = radius_in * 2.54 / 100.0
    t = np.linspace(0.0, 2.0 * np.pi, n_motors + 1)[:-1]
    t = t + (t[1] - t[0]) / 2.0
    return r * np.stack([np.cos(t), np.sin(t), np.zeros(n_motors)], axis=-1)


@dataclass(frozen=True)
class DroneParams:
    """Static physics constants (frozen, hashable). Built from
    :class:`FpyvConfig` with the reference's unit conversions: grams→kg,
    cm→m (components.py:96-100)."""

    dt: float = 1.0 / 60.0
    gravity: float = 9.81
    mass: float = 0.75  # kg
    max_rates: float = 200.0  # deg/s
    drag_coef: Tuple[float, float, float] = (1.8, 1.8, 1.2)
    cross_sections: Tuple[float, float, float] = (0.30 * 0.05, 0.26 * 0.05, 0.26 * 0.30)
    rates_transition_rate: float = 0.7
    thrust_transition_rate: float = 0.5
    n_motors: int = 4
    motor_radius: float = 0.1
    thrust_curve: ThrustCurve = field(default_factory=default_thrust_curve)
    att_mode: str = "rotmat"  # 'rotmat' | 'quat'
    double_rotation_quirk: bool = True

    @classmethod
    def from_config(cls, cfg: FpyvConfig, att_mode: str = "rotmat",
                    double_rotation_quirk: bool = True) -> "DroneParams":
        d = cfg.drone
        dims_m = tuple(x / 100.0 for x in d.dimensions)  # components.py:99
        cross = (dims_m[1] * dims_m[2], dims_m[0] * dims_m[2], dims_m[0] * dims_m[1])
        if d.motor_test_report_path:
            curve = thrust_curve_from_csv(
                d.motor_test_report_path, d.motor_test_report_idx,
                n_motors=4, gravity=cfg.simulator.gravity)
        else:
            curve = default_thrust_curve(
                d.motor_test_report_idx, n_motors=4, gravity=cfg.simulator.gravity)
        return cls(
            dt=cfg.simulator.dt,
            gravity=cfg.simulator.gravity,
            mass=d.mass / 1000.0,
            max_rates=d.max_rates,
            drag_coef=tuple(d.drag_coefficients),
            cross_sections=cross,
            rates_transition_rate=d.rates_transition_rate,
            thrust_transition_rate=d.thrust_transition_rate,
            thrust_curve=curve,
            att_mode=att_mode,
            double_rotation_quirk=double_rotation_quirk,
        )

    @property
    def motors_relative_position(self) -> np.ndarray:
        return motor_layout(self.n_motors)


@dataclass
class DroneState:
    """Per-drone dynamic state; every field takes leading batch dims."""

    pos: torch.Tensor  # (..., 3) world position [m]
    vel: torch.Tensor  # (..., 3) world velocity [m/s]
    att: torch.Tensor  # (..., 3, 3) rotation matrix | (..., 4) quaternion (w,x,y,z)
    rates: torch.Tensor  # (..., 3) low-passed body rates [deg/s]
    thrust: torch.Tensor  # (...,) low-passed thrust scalar [N]
    accel: torch.Tensor  # (..., 3) world acceleration of the last step
    done: torch.Tensor  # (...,) bool crash flag

    def replace(self, **changes) -> "DroneState":
        return dataclasses.replace(self, **changes)


@dataclass
class DomainRand:
    """Per-env multiplicative randomization of mass/drag/thrust; 1.0 = nominal."""

    mass_scale: torch.Tensor
    drag_scale: torch.Tensor
    thrust_scale: torch.Tensor

    def replace(self, **changes) -> "DomainRand":
        return dataclasses.replace(self, **changes)

    @classmethod
    def nominal(cls, batch_shape=(), dtype=torch.float32, device=None) -> "DomainRand":
        o = torch.ones(tuple(batch_shape), dtype=dtype, device=resolve_device(device))
        return cls(mass_scale=o, drag_scale=o.clone(), thrust_scale=o.clone())

    @classmethod
    def sample(cls, generator: torch.Generator, batch_shape=(), mass_range=(0.8, 1.2),
               drag_range=(0.7, 1.3), thrust_range=(0.85, 1.15),
               dtype=torch.float32, device=None) -> "DomainRand":
        def u(r):
            x = torch.rand(tuple(batch_shape), generator=generator, dtype=dtype,
                           device=generator.device)
            return (r[0] + x * (r[1] - r[0])).to(resolve_device(device))

        return cls(mass_scale=u(mass_range), drag_scale=u(drag_range),
                   thrust_scale=u(thrust_range))


@dataclass
class ImuObs:
    """The reference's step return tuple (components.py:247-248)."""

    world_from_body_T: torch.Tensor  # (..., 3, 3) R_newᵀ
    gyro_matrix: torch.Tensor  # (..., 3, 3) E(rates), deg/s read as radians
    accel_body: torch.Tensor  # (..., 3) R_new @ accel


# ---------------------------------------------------------------------------
# Attitude-mode helpers
# ---------------------------------------------------------------------------


def _att_to_rotmat(params: DroneParams, att: torch.Tensor) -> torch.Tensor:
    return att if params.att_mode == "rotmat" else rot.quat_to_rotmat(att)


def _advance_attitude(params: DroneParams, att, rates_deg, dt):
    if params.att_mode == "rotmat":
        return rot.rotate_body_by_rates(att, rates_deg, dt)
    return rot.quat_rotate_by_rates(att, rates_deg, dt)


def attitude_from_euler(params: DroneParams, euler_rad: torch.Tensor) -> torch.Tensor:
    if params.att_mode == "rotmat":
        return rot.euler_to_rotmat(euler_rad)
    return rot.euler_to_quat(euler_rad)


# ---------------------------------------------------------------------------
# Physics
# ---------------------------------------------------------------------------


def calculate_drag(params: DroneParams, R, velocity, wind):
    """``R @ (-½ Cd ρ A (Rᵀ (v+w)) |v+w|)`` (kinematics.py:33-38)."""
    vsum = velocity + wind
    v_body = rot.mat3_vec_T(R, vsum)
    kw = dict(dtype=v_body.dtype, device=v_body.device)
    coef = (-0.5 * AIR_DENSITY) * torch.tensor(params.drag_coef, **kw) * torch.tensor(
        params.cross_sections, **kw)
    f_body = coef * v_body * torch.linalg.vector_norm(vsum, dim=-1, keepdim=True)
    return rot.mat3_vec(R, f_body)


def gravity_vector(params: DroneParams, dtype=torch.float32, device=None):
    """[0, 0, -m g] (kinematics.py:41-45) on ``device`` (CUDA unless told)."""
    return torch.tensor([0.0, 0.0, -params.gravity * params.mass], dtype=dtype,
                        device=resolve_device(device))


def action_to_rates_thrust(params: DroneParams, state: DroneState, action):
    """components.py:179-196 minus the thrust vectorization: low-passed
    rates (deg/s) and thrust scalar (N); throttle clipped to [-1, 1]."""
    rates_cmd = torch.clamp(-action[..., :3] * params.max_rates,
                            -params.max_rates, params.max_rates)
    rates = (rates_cmd * params.rates_transition_rate
             + state.rates * (1.0 - params.rates_transition_rate))
    thrust = (params.thrust_curve.throttle_to_thrust(torch.clamp(action[..., 3], -1.0, 1.0))
              * params.thrust_transition_rate
              + state.thrust * (1.0 - params.thrust_transition_rate))
    return rates, thrust


def drone_reset(params: DroneParams, position, velocity, ypr_deg) -> DroneState:
    """components.py:150-169: attitude from deg Euler angles, zeroed memories."""
    position = torch.as_tensor(position)
    velocity = torch.as_tensor(velocity, dtype=position.dtype, device=position.device)
    euler = torch.deg2rad(torch.as_tensor(ypr_deg, dtype=position.dtype,
                                          device=position.device))
    att = attitude_from_euler(params, euler)
    batch = tuple(position.shape[:-1])
    kw = dict(dtype=position.dtype, device=position.device)
    return DroneState(
        pos=position,
        vel=velocity,
        att=att,
        rates=torch.zeros(batch + (3,), **kw),
        thrust=torch.zeros(batch, **kw),
        accel=torch.zeros(batch + (3,), **kw),
        done=torch.zeros(batch, dtype=torch.bool, device=position.device),
    )


def drone_step(
    params: DroneParams,
    state: DroneState,
    action: torch.Tensor,  # (..., 4) [roll, pitch, yaw, throttle] in [-1, 1]
    world: World,
    wind: Optional[torch.Tensor] = None,  # (..., 3) world-frame wind velocity
    att_override: Optional[torch.Tensor] = None,  # (..., 3, 3) guidance attitude
    thrust_override: Optional[torch.Tensor] = None,  # (...,) guidance |F|
    domain_rand: Optional[DomainRand] = None,
) -> Tuple[DroneState, ImuObs]:
    """One physics step. See the module docstring for the semantics."""
    dtype, device = state.pos.dtype, state.pos.device
    kw = dict(dtype=dtype, device=device)
    action = torch.as_tensor(action, **kw)
    wind = torch.zeros(3, **kw) if wind is None else torch.as_tensor(wind, **kw)

    rates, thrust_scalar = action_to_rates_thrust(params, state, action)
    if domain_rand is not None:
        thrust_scalar = thrust_scalar * domain_rand.thrust_scale

    att = state.att
    if att_override is not None:
        att = att_override if params.att_mode == "rotmat" else rot.rotmat_to_quat(att_override)
    R = _att_to_rotmat(params, att)
    applied_thrust = thrust_scalar if thrust_override is None else thrust_override
    thrust_vec = R[..., :, 2] * applied_thrust[..., None]

    drag = calculate_drag(params, R, state.vel, wind)
    gravity = gravity_vector(params, **kw)
    mass = torch.tensor(params.mass, **kw)
    if domain_rand is not None:
        drag = drag * domain_rand.drag_scale[..., None]
        mass = mass * domain_rand.mass_scale
        gravity = gravity * domain_rand.mass_scale[..., None]

    # motor points: position + motors_rel @ Rᵀ (components.py:235), elementwise
    mr = torch.as_tensor(params.motors_relative_position, **kw)  # (M, 3)
    Rb = R[..., None, :, :]
    motor_world = (Rb[..., 0] * mr[:, None, 0] + Rb[..., 1] * mr[:, None, 1]
                   + Rb[..., 2] * mr[:, None, 2])
    motor_points = state.pos[..., None, :] + motor_world

    contact_force, crashed = collisions.collide(
        world, motor_points, state.vel, motor_radius=params.motor_radius)
    done = state.done | crashed

    total_force = thrust_vec + gravity + drag + contact_force
    accel = total_force / (mass[..., None] if domain_rand is not None else params.mass)

    pos = state.pos + state.vel * params.dt
    vel = state.vel + accel * params.dt
    att_new = _advance_attitude(params, att, rates, params.dt)
    if params.double_rotation_quirk:
        att_new = _advance_attitude(params, att_new, rates, params.dt)

    new_state = DroneState(pos=pos, vel=vel, att=att_new, rates=rates,
                           thrust=thrust_scalar, accel=accel, done=done)
    R_new = _att_to_rotmat(params, att_new)
    obs = ImuObs(
        world_from_body_T=R_new.transpose(-1, -2),
        gyro_matrix=rot.euler_to_rotmat(rates),
        accel_body=rot.mat3_vec(R_new, accel),
    )
    return new_state, obs


def gravity_in_body_frame(params: DroneParams, state: DroneState):
    """R @ [0,0,-mg] with g=9.81 hardcoded (components.py:255-256 parity)."""
    R = _att_to_rotmat(params, state.att)
    g = torch.tensor([0.0, 0.0, -9.81 * params.mass], dtype=state.pos.dtype,
                     device=state.pos.device)
    return rot.mat3_vec(R, g)
