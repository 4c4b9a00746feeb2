"""Pixel-guidance autopilots: fly the drone toward a pixel in its camera
(mirrors ``fpyv_tpu.control.guidance``).

Reference parity (src/utils/components.py):

- ``needed_force_orientation`` ports ``calculate_needed_force_orientation``
  (:258-304): from a target pixel, the world-frame force that chases it —
  distance-keeping PID on the UWB-clamped range, "virtual drag" opposing
  motion away from the target, "virtual ground-effect lift" below
  ``tof_effective_distance``, minus gravity — and the attitude whose +z
  column applies that force ("level": y = F×g; "frontarget": y = F×dir).
- ``point_and_shoot`` ports :312-381: the action offsets a virtual target
  on screen, the PID tracks the pixel ROW, and a saturation loop rescales
  the PID multiplier until ‖F‖ fits under the motor ceiling.
- ``point_and_shoot_optimize`` replaces the reference's unfinished
  optimizer sketch (:389-429) with a bisection on the multiplier.

Each returns (R_desired, ‖F‖), which ``drone_step`` applies through its
att_override/thrust_override path (components.py:230-232). The reference's
g = 9.81 hardcode here (independent of params.gravity) is kept.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.config import FpyvConfig
from fpyv_tpu_torch.control.pid import PidParams, PidState, pid_init, pid_step
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.vision.camera import CameraRig, pixel_to_direction


@dataclass(frozen=True)
class GuidanceParams:
    virtual_drag_coef: float = 0.5  # params.yaml point_and_shoot block
    virtual_lift_coef: float = 0.1
    tof_effective_distance: float = 2.0
    keep_distance: float = 6.0
    uwb_max_range: float = 13.0
    mode: str = "level"  # 'level' | 'frontarget'
    pid: PidParams = field(default_factory=lambda: PidParams(
        kP=0.1, kI=2.0, kD=0.05, dt=1 / 60, integral_clip=100.0,
        min_output=0.05, max_output=40.0, derivative_transition_rate=0.2))

    @classmethod
    def from_config(cls, cfg: FpyvConfig, drone_params: DroneParams,
                    dt: Optional[float] = None) -> "GuidanceParams":
        pns = cfg.point_and_shoot
        pid_cfg = cfg.drone.force_multiplier_pid
        curve = drone_params.thrust_curve
        return cls(
            virtual_drag_coef=pns.virtual_drag_coefficient,
            virtual_lift_coef=pns.virtual_lift_coefficient,
            tof_effective_distance=pns.tof_effective_distance,
            keep_distance=cfg.drone.keep_distance,
            uwb_max_range=cfg.drone.UWB_sensor_max_range,
            mode=pns.mode,
            # min/max output overwritten by the thrust-curve force limits
            # (components.py:143-144)
            pid=PidParams(
                kP=pid_cfg.kP, kI=pid_cfg.kI, kD=pid_cfg.kD,
                dt=dt if dt is not None else drone_params.dt,
                integral_clip=pid_cfg.integral_clip,
                min_output=curve.min_force, max_output=curve.max_force,
                derivative_transition_rate=pid_cfg.derivative_transition_rate,
            ),
        )


@dataclass
class GuidanceState:
    pid: PidState
    prev_pixel: torch.Tensor  # (..., 2)
    pixel_velocity: torch.Tensor  # (..., 2)
    has_prev: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "GuidanceState":
        return dataclasses.replace(self, **changes)


def guidance_init(batch_shape=(), dtype=torch.float32, device=None) -> GuidanceState:
    """Fresh guidance state on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    shape = tuple(batch_shape)
    return GuidanceState(
        pid=pid_init(shape, dtype, device),
        prev_pixel=torch.zeros(shape + (2,), dtype=dtype, device=device),
        pixel_velocity=torch.zeros(shape + (2,), dtype=dtype, device=device),
        has_prev=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def _gravity(mass: float, like: torch.Tensor) -> torch.Tensor:
    """g pinned to 9.81 here regardless of sim gravity (components.py:270)."""
    return torch.tensor([0.0, 0.0, -9.81 * mass], dtype=like.dtype, device=like.device)


def _virtual_drag(velocity, dir2target, coef: float):
    """components.py:271-285: ``-(v̂·d - 1)/2 · (-v) · ‖v‖ · coef``, which
    fires only when moving away from the target."""
    vnorm = torch.linalg.vector_norm(velocity, dim=-1, keepdim=True)
    vhat = velocity / torch.clamp_min(vnorm, 1e-12)
    cosang = (vhat * dir2target).sum(-1, keepdim=True)
    return coef * (-(cosang - 1.0) / 2.0) * (-velocity) * vnorm


def _force_basis(force, second_ref):
    """Attitude whose z column is the (normalized) force: columns [x, y, F]
    with y = F × ref, x = y × F, each normalized (components.py:294-303)."""
    y = torch.linalg.cross(force, second_ref, dim=-1)
    x = torch.linalg.cross(y, force, dim=-1)
    R = torch.stack([x, y, force], dim=-1)
    return R / torch.clamp_min(torch.linalg.vector_norm(R, dim=-2, keepdim=True), 1e-12)


def needed_force_orientation(
    g: GuidanceParams,
    state: GuidanceState,
    rig: CameraRig,
    cam_R: torch.Tensor,  # (..., 3, 3) camera-to-world rotation
    pixel: torch.Tensor,  # (..., 2) target pixel
    position: torch.Tensor,  # (..., 3) drone position
    velocity: torch.Tensor,  # (..., 3)
    dist_to_target: torch.Tensor,  # (...,) SDF distance to target (pre-clamp)
    mass: float,
) -> Tuple[GuidanceState, torch.Tensor, torch.Tensor]:
    """Port of calculate_needed_force_orientation (components.py:258-304),
    ref_frame='world'. Returns (state, R_desired (..., 3, 3), |F| (...,))."""
    dir2target = pixel_to_direction(rig, cam_R, pixel)
    gravity = _gravity(mass, position)
    vdrag = _virtual_drag(velocity, dir2target, g.virtual_drag_coef)
    below = (position[..., 2] < g.tof_effective_distance).to(position.dtype)
    vlift = (below[..., None]
             * -(g.tof_effective_distance - position[..., 2])[..., None]
             * g.virtual_lift_coef * gravity
             * (1.0 + torch.abs(velocity[..., 2]))[..., None])  # components.py:286
    measured = torch.clamp_max(dist_to_target, g.uwb_max_range)  # :287
    pid_state, mult = pid_step(g.pid, state.pid, measured, g.keep_distance)
    mult = torch.clamp(mult, g.pid.min_output, g.pid.max_output)  # :290 (redundant)
    force = mult[..., None] * dir2target + vdrag + vlift - gravity  # :292
    force_norm = torch.linalg.vector_norm(force, dim=-1)
    second = gravity if g.mode == "level" else dir2target
    R_des = _force_basis(force, torch.broadcast_to(second, force.shape))
    return state.replace(pid=pid_state), R_des, force_norm


def point_and_shoot(
    g: GuidanceParams,
    state: GuidanceState,
    rig: CameraRig,
    cam_R: torch.Tensor,
    pixel: torch.Tensor,  # (..., 2) target pixel (before the virtual offset)
    action: torch.Tensor,  # (..., 4) [x-screen, y-screen, orbit, over/under]
    position: torch.Tensor,
    velocity: torch.Tensor,
    mass: float,
    max_force: float,
    dt: float,
) -> Tuple[GuidanceState, torch.Tensor, torch.Tensor]:
    """Port of point_and_shoot (components.py:312-381), ref_frame='world'.
    Returns (state, R_desired, |F|)."""
    res = torch.tensor(rig.resolution, dtype=position.dtype, device=position.device)
    pixel = pixel + action[..., 2:4] * res / 2.0  # virtual target (:322-323)
    pixel_velocity = torch.where(state.has_prev[..., None], (pixel - state.prev_pixel) / dt,
                                 torch.zeros_like(pixel))

    dir2target = pixel_to_direction(rig, cam_R, pixel)
    gravity = _gravity(mass, position)
    vdrag = _virtual_drag(velocity, dir2target, g.virtual_drag_coef)
    below = (position[..., 2] < g.tof_effective_distance).to(position.dtype)
    vz_neg = -torch.clamp_max(velocity[..., 2], 0.0)  # :345
    vlift = (below[..., None]
             * -(g.tof_effective_distance - position[..., 2])[..., None]
             * g.virtual_lift_coef * gravity * vz_neg[..., None])

    # screen-position setpoint (:348-350): PID on the pixel ROW
    screen_pos = torch.trunc(res / 2.0 * (1.0 + action[..., 0:2]))  # :383-387
    pid_state, mult = pid_step(g.pid, state.pid, pixel[..., 1], screen_pos[..., 1])

    def total_force(m):
        return m[..., None] * dir2target + vdrag + vlift - gravity

    force = total_force(mult)
    force_norm = torch.linalg.vector_norm(force, dim=-1)
    # saturation loop (:357-366): shrink mult until ‖F‖ <= max_force; a
    # fixed 4 masked iterations (first criteria 0.9999, then max/‖F‖)
    criteria = torch.full_like(force_norm, 0.9999)
    for _ in range(4):
        over = force_norm > max_force
        new_mult = torch.clamp(mult * criteria, g.pid.min_output, g.pid.max_output)
        mult = torch.where(over, new_mult, mult)
        force = total_force(mult)
        force_norm = torch.linalg.vector_norm(force, dim=-1)
        criteria = max_force / torch.clamp_min(force_norm, 1e-12)

    second = gravity if g.mode == "level" else dir2target
    R_des = _force_basis(force, torch.broadcast_to(second, force.shape))
    new_state = state.replace(pid=pid_state, prev_pixel=pixel, pixel_velocity=pixel_velocity,
                              has_prev=torch.ones_like(state.has_prev))
    return new_state, R_des, force_norm


def point_and_shoot_optimize(
    g: GuidanceParams,
    rig: CameraRig,
    cam_R: torch.Tensor,
    pixel: torch.Tensor,  # (..., 2) target pixel in the current frame
    position: torch.Tensor,
    velocity: torch.Tensor,
    mass: float,
    max_force: float,
    desired_row_fraction: float = 0.5,
    iterations: int = 12,
):
    """Working replacement for the reference's unfinished
    ``point_and_shoot_optimizer`` (components.py:389-429): bisection on the
    force multiplier over [pid.min_output, max_force] so that, after the
    drone re-orients to apply the force, the target reprojects at the
    desired screen row. Returns (R_desired, |F|, final_pixel_row)."""
    from fpyv_tpu_torch.ops import rotations as rot
    from fpyv_tpu_torch.ops.camera_ops import project_camera_points

    dir2target = pixel_to_direction(rig, cam_R, pixel)
    gravity = _gravity(mass, position)
    vdrag = _virtual_drag(velocity, dir2target, g.virtual_drag_coef)
    _, H = rig.resolution
    kw = dict(dtype=position.dtype, device=position.device)
    K = torch.as_tensor(rig.K, **kw)
    mount = torch.as_tensor(rig.mount_rotation, **kw)
    target_row = desired_row_fraction * H

    def row_of(mult):
        force = mult[..., None] * dir2target + vdrag - gravity
        second = gravity if g.mode == "level" else dir2target
        R_body = _force_basis(force, torch.broadcast_to(second, force.shape))
        cam = rot.mat3_mul(R_body, mount)  # camera_pose's rotation composition
        d_cam = rot.mat3_vec_T(cam, dir2target)
        _, v, depth = project_camera_points(d_cam[..., None, :], K)
        # behind-camera candidates walk the bracket toward more thrust
        row = torch.where(depth[..., 0] > 1e-6, v[..., 0], torch.full_like(v[..., 0], 1e6))
        return row, R_body, force

    lo = torch.full(position.shape[:-1], g.pid.min_output, **kw)
    hi = torch.full(position.shape[:-1], max_force, **kw)
    for _ in range(iterations):  # fixed bisection, branch-free
        mid = 0.5 * (lo + hi)
        row, _, _ = row_of(mid)
        add_thrust = row > target_row  # the row falls as the multiplier grows
        lo = torch.where(add_thrust, mid, lo)
        hi = torch.where(add_thrust, hi, mid)
    row, R_des, force = row_of(0.5 * (lo + hi))
    fnorm = torch.clamp_max(torch.linalg.vector_norm(force, dim=-1), max_force)
    return R_des, fnorm, row
