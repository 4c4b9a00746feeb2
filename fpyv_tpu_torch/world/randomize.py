"""Per-env batched worlds for domain randomization (mirrors
``fpyv_tpu.world.randomize``).

World fields broadcast against env batches throughout the physics and the
renderers, so a World whose fields carry a leading (N,) axis gives every env
its own obstacle course. Draws come from a ``torch.Generator``: the same
distributions as the JAX module's ``jax.random`` draws, not the same
numbers.

Usage:
    worlds = sample_worlds(generator, n_envs, n_spheres=1, n_cylinders=4)
    state, obs = env.reset(generator, worlds, (n_envs,))
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.physics.world import World, empty_world


@dataclass(frozen=True)
class WorldRanges:
    """Uniform sampling ranges mirroring params.yaml's generator blocks."""

    target_center: Tuple[float, float, float] = (0.0, 0.0, 3.0)
    target_center_std: float = 0.1  # targets block `std`
    target_radius: Tuple[float, float] = (0.8, 1.2)
    target_path_radius: Tuple[float, float] = (20.0, 30.0)
    target_path_res: int = 5500
    moving_targets: bool = True
    cyl_xy_std: float = 10.0  # obstacles block `center_std`
    cyl_radius: Tuple[float, float] = (1.0, 3.0)
    cyl_height: Tuple[float, float] = (4.0, 16.0)


def sample_worlds(generator: torch.Generator, n_envs: int, n_spheres: int = 1,
                  n_cylinders: int = 4, ranges: WorldRanges = WorldRanges(),
                  dtype=torch.float32, device=None) -> World:
    """A batched World on ``device`` (CUDA unless told): every field gains a
    leading (n_envs,) axis."""
    device = resolve_device(device)
    S, C = max(n_spheres, 1), max(n_cylinders, 1)

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device).to(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
        return (lo + u * (hi - lo)).to(device)

    center = torch.tensor(ranges.target_center, dtype=dtype, device=device)
    sphere_center = center + ranges.target_center_std * normal((n_envs, S, 3))
    sphere_radius = uniform((n_envs, S), *ranges.target_radius)
    path_radius = uniform((n_envs, S), *ranges.target_path_radius)
    cyl_xy = ranges.cyl_xy_std * normal((n_envs, C, 2))
    cyl_center = torch.cat([cyl_xy, torch.zeros((n_envs, C, 1), dtype=dtype, device=device)],
                           dim=-1)
    cyl_radius = uniform((n_envs, C), *ranges.cyl_radius)
    cyl_height = uniform((n_envs, C), *ranges.cyl_height)

    base = empty_world(n_spheres, n_cylinders, 0, ground=True, dtype=dtype, device=device)

    def tile(x):
        return x.expand((n_envs,) + tuple(x.shape)).clone()

    return base.replace(
        sphere_center=sphere_center,
        sphere_radius=sphere_radius,
        sphere_active=tile(base.sphere_active),
        sphere_path_center=sphere_center.clone(),
        sphere_path_radius=path_radius if ranges.moving_targets else torch.zeros_like(path_radius),
        sphere_path_res=torch.full((n_envs, S), ranges.target_path_res, dtype=torch.int32,
                                   device=device),
        sphere_path_count=tile(base.sphere_path_count),
        sphere_has_path=torch.full((n_envs, S), bool(ranges.moving_targets), device=device),
        cyl_center=cyl_center,
        cyl_radius=cyl_radius,
        cyl_height=cyl_height,
        cyl_active=tile(base.cyl_active),
        gate_pos=tile(base.gate_pos),
        gate_rotmat=tile(base.gate_rotmat),
        gate_size=tile(base.gate_size),
        gate_active=tile(base.gate_active),
        gate_shape=tile(base.gate_shape),
        has_ground=tile(base.has_ground),
    )


def curriculum_worlds(generator: torch.Generator, n_envs: int, difficulty,
                      n_spheres: int = 1, n_cylinders: int = 4,
                      ranges: WorldRanges = WorldRanges(), dtype=torch.float32,
                      device=None) -> World:
    """Difficulty-ramped :func:`sample_worlds`: ``difficulty`` in [0, 1]
    ramps the obstacle COUNT from 1 to n_cylinders through the active mask
    and the obstacle RADIUS from 60 % to 100 % of the sampled value."""
    w = sample_worlds(generator, n_envs, n_spheres, n_cylinders, ranges, dtype, device)
    d = torch.clamp(torch.as_tensor(difficulty, dtype=dtype, device=w.cyl_radius.device),
                    0.0, 1.0)
    C = max(n_cylinders, 1)
    n_active = torch.ceil(d * C).to(torch.int32)
    ramp = (torch.arange(C, device=d.device) < n_active).expand(w.cyl_active.shape)
    return w.replace(cyl_active=w.cyl_active & ramp, cyl_radius=w.cyl_radius * (0.6 + 0.4 * d))
