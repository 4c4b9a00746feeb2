"""Motor-point collision handling: crash detection + spring contact forces
(mirrors ``fpyv_tpu.physics.collisions``).

- SDFs are evaluated at the drone's 4 motor points (components.py:235).
- any signed distance < 0 -> crash; distance - motor_radius < 0 -> spring
  force ``F = (-k (d - r_m) - c (v . n)) n`` with k=100, c=0.
- gates never collide; the ground does, and any motor z < 0 is a crash
  whether or not the world has a ground (components.py:239-240).

As in the JAX package, the full force field is always summed, where the
reference returns early on a crash frame; a crash ends the episode, so the
difference is never observable.
"""

from __future__ import annotations

import torch

from fpyv_tpu_torch.physics.world import World, cylinder_sdf, ground_sdf, sphere_sdf

SPRING_CONSTANT = 100.0  # components.py:198 (call-site default)
DAMPING_CONSTANT = 0.0
MOTOR_RADIUS = 0.1  # components.py:121


def _spring(d_pen, normal, velocity, k, c):
    """``(-k d - c (v . n)) n`` (kinematics.py:56-59)."""
    vn = (velocity[..., None, None, :] * normal).sum(-1)
    mag = -k * d_pen - c * vn
    return mag[..., None] * normal


def collide(
    world: World,
    motor_points: torch.Tensor,  # (..., M, 3)
    velocity: torch.Tensor,  # (..., 3)
    motor_radius: float = MOTOR_RADIUS,
    spring_constant: float = SPRING_CONSTANT,
    damping_constant: float = DAMPING_CONSTANT,
):
    """Returns (force (..., 3), crashed (...,) bool) over all active objects."""
    total_force = torch.zeros(motor_points.shape[:-2] + (3,), dtype=motor_points.dtype,
                              device=motor_points.device)
    crashed = torch.zeros(motor_points.shape[:-2], dtype=torch.bool,
                          device=motor_points.device)

    def accumulate(d, n, active, force, crash):
        pen = (d - motor_radius < 0) & active[..., :, None]
        f = _spring(d - motor_radius, n, velocity, spring_constant, damping_constant)
        force = force + torch.where(pen[..., None], f, 0.0).sum(dim=(-3, -2))
        crash = crash | ((d < 0) & active[..., :, None]).any(-1).any(-1)
        return force, crash

    if world.num_spheres:
        d, n = sphere_sdf(world.sphere_center, world.sphere_radius, motor_points)
        total_force, crashed = accumulate(d, n, world.sphere_active, total_force, crashed)
    if world.num_cylinders:
        d, n = cylinder_sdf(world.cyl_center, world.cyl_radius, world.cyl_height,
                            motor_points)
        total_force, crashed = accumulate(d, n, world.cyl_active, total_force, crashed)

    dg, ng = ground_sdf(motor_points)
    pen_g = (dg - motor_radius < 0) & world.has_ground[..., None]  # per-env worlds: (N,)
    vng = (velocity[..., None, :] * ng).sum(-1)
    fg = (-spring_constant * (dg - motor_radius) - damping_constant * vng)[..., None] * ng
    total_force = total_force + torch.where(pen_g[..., None], fg, 0.0).sum(-2)
    crashed = crashed | (dg < 0).any(-1)
    return total_force, crashed
