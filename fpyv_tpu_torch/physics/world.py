"""Static-shape SoA world: targets (spheres), cylinders, gates, ground
(mirrors ``fpyv_tpu.physics.world``).

Worlds are structure-of-arrays with per-object active masks; every SDF
evaluates branch-free over every (object, query-point) pair and masked
terms contribute zero. Field names, shapes and dtypes follow the flax
``World`` one for one (bool masks, int32 path counters).

SDF semantics, as in the JAX package:

- Sphere/Target (components.py:773-777): d = |p - c| - r; n = (p-c)/|p-c|.
- Cylinder (components.py:710-729): radial distance inside the height band,
  else sqrt(radial^2 + dz^2), with both reference quirks: the absolute band
  sets the distance, while ``calculate_normal`` compares the *relative* z
  with the *absolute* band. ``relative_band_quirk=False`` fixes the normal.
- Ground (components.py:674-680): d = z, n = +z.
- Gate (components.py:819-822): signed plane distance; gates never collide.
- CircularPath targets (components.py:743-751,769-771): position_k =
  path_center + [R cos(2πk/res), R sin(2πk/res), 0], k += 1 per step.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import torch

from fpyv_tpu_torch.device import resolve_device


@dataclass
class World:
    """SoA world. Leading dims of each field broadcast against env batches."""

    sphere_center: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)
    sphere_active: torch.Tensor  # (S,) bool
    sphere_path_center: torch.Tensor  # (S, 3)
    sphere_path_radius: torch.Tensor  # (S,)
    sphere_path_res: torch.Tensor  # (S,) int32 points per revolution
    sphere_path_count: torch.Tensor  # (S,) int32 CircularPath.count
    sphere_has_path: torch.Tensor  # (S,) bool
    cyl_center: torch.Tensor  # (C, 3) base-center position
    cyl_radius: torch.Tensor  # (C,)
    cyl_height: torch.Tensor  # (C,)
    cyl_active: torch.Tensor  # (C,) bool
    gate_pos: torch.Tensor  # (G, 3)
    gate_rotmat: torch.Tensor  # (G, 3, 3)
    gate_size: torch.Tensor  # (G,)
    gate_active: torch.Tensor  # (G,) bool
    gate_shape: torch.Tensor  # (G,) int32: 0 rectangle, 1 circle, 2 half_circle
    has_ground: torch.Tensor  # () bool

    @property
    def num_spheres(self) -> int:
        return self.sphere_center.shape[-2]

    @property
    def num_cylinders(self) -> int:
        return self.cyl_center.shape[-2]

    @property
    def num_gates(self) -> int:
        return self.gate_pos.shape[-2]

    def replace(self, **changes) -> "World":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "World":
        return World(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


def empty_world(n_spheres: int = 0, n_cylinders: int = 0, n_gates: int = 0,
                ground: bool = True, dtype=torch.float32, device=None) -> World:
    """A fully-masked world with the given static capacities on ``device``
    (CUDA unless told)."""
    S, C, G = max(n_spheres, 1), max(n_cylinders, 1), max(n_gates, 1)
    kw = dict(device=resolve_device(device))

    def mask(n, cap):
        m = torch.zeros((cap,), dtype=torch.bool, **kw)
        m[:n] = n > 0
        return m

    return World(
        sphere_center=torch.zeros((S, 3), dtype=dtype, **kw),
        sphere_radius=torch.ones((S,), dtype=dtype, **kw),
        sphere_active=mask(n_spheres, S),
        sphere_path_center=torch.zeros((S, 3), dtype=dtype, **kw),
        sphere_path_radius=torch.zeros((S,), dtype=dtype, **kw),
        sphere_path_res=torch.ones((S,), dtype=torch.int32, **kw),
        sphere_path_count=torch.zeros((S,), dtype=torch.int32, **kw),
        sphere_has_path=torch.zeros((S,), dtype=torch.bool, **kw),
        cyl_center=torch.zeros((C, 3), dtype=dtype, **kw),
        cyl_radius=torch.ones((C,), dtype=dtype, **kw),
        cyl_height=torch.ones((C,), dtype=dtype, **kw),
        cyl_active=mask(n_cylinders, C),
        gate_pos=torch.zeros((G, 3), dtype=dtype, **kw),
        gate_rotmat=torch.eye(3, dtype=dtype, **kw).expand(G, 3, 3).clone(),
        gate_size=torch.ones((G,), dtype=dtype, **kw),
        gate_active=mask(n_gates, G),
        gate_shape=torch.zeros((G,), dtype=torch.int32, **kw),
        has_ground=torch.tensor(bool(ground), **kw),
    )


GATE_SHAPES = ("rectangle", "circle", "half_circle")  # gate_shape codes 0/1/2


# ---------------------------------------------------------------------------
# SDFs (batched over query points; masked-object aware)
# ---------------------------------------------------------------------------


def sphere_sdf(center, radius, points):
    """center (..., S, 3), radius (..., S), points (..., M, 3) ->
    d (..., S, M), n (..., S, M, 3)."""
    rel = points[..., None, :, :] - center[..., :, None, :]
    dist = torch.linalg.vector_norm(rel, dim=-1)
    d = dist - radius[..., :, None]
    n = rel / torch.clamp_min(dist, 1e-12)[..., None]
    return d, n


def cylinder_sdf(center, radius, height, points, relative_band_quirk: bool = True):
    """Vertical cylinder signed distance + normal with both reference quirks.

    center (..., C, 3), radius/height (..., C), points (..., M, 3) ->
    d (..., C, M), n (..., C, M, 3).
    """
    rel = points[..., None, :, :] - center[..., :, None, :]
    d2d = torch.linalg.vector_norm(rel[..., :2], dim=-1) - radius[..., :, None]
    z0 = center[..., :, None, 2]
    z1 = z0 + height[..., :, None]
    pz = points[..., None, :, 2]
    in_band = (z0 < pz) & (pz < z1)
    dh = torch.minimum(torch.abs(pz - z0), torch.abs(pz - z1))
    d = torch.where(in_band, d2d, torch.sqrt(d2d * d2d + dh * dh))

    qz = rel[..., 2]
    band_for_normal = (z0 < qz) & (qz < z1) if relative_band_quirk else in_band
    side_n = torch.cat([rel[..., :2], torch.zeros_like(rel[..., :1])], dim=-1)
    side_n = side_n / torch.clamp_min(
        torch.linalg.vector_norm(side_n, dim=-1, keepdim=True), 1e-12)
    zq = qz if relative_band_quirk else pz
    cap_sign = torch.where(torch.abs(zq - z0) < torch.abs(zq - z1), -1.0, 1.0).to(rel.dtype)
    cap_n = torch.cat([torch.zeros_like(rel[..., :2]), cap_sign[..., None]], dim=-1)
    n = torch.where(band_for_normal[..., None], side_n, cap_n)
    return d, n


def ground_sdf(points):
    """Plane z=0: points (..., M, 3) -> d (..., M), n (..., M, 3)."""
    d = points[..., 2]
    n = torch.zeros_like(points)
    n[..., 2] = 1.0
    return d, n


def gate_plane_distance(gate_pos, gate_rotmat, points):
    """Signed distance to each gate plane (normal = R[:, 0]); race progress
    only (components.py:811-822). Returns (..., G, M)."""
    normal = gate_rotmat[..., :, 0]
    rel = points[..., None, :, :] - gate_pos[..., :, None, :]
    return (rel * normal[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Target motion (CircularPath)
# ---------------------------------------------------------------------------


def update_targets(world: World) -> World:
    """Advance moving targets one path step: place each at
    ``count % res`` on its circle, then increment the count."""
    dtype = world.sphere_center.dtype
    res = torch.clamp_min(world.sphere_path_res, 1)
    theta = (2.0 * math.pi) * (
        torch.remainder(world.sphere_path_count, res).to(dtype) / res.to(dtype))
    offset = torch.stack([
        torch.cos(theta) * world.sphere_path_radius,
        torch.sin(theta) * world.sphere_path_radius,
        torch.zeros_like(theta),
    ], dim=-1)
    new_center = torch.where(world.sphere_has_path[..., None],
                             world.sphere_path_center + offset, world.sphere_center)
    return world.replace(
        sphere_center=new_center,
        sphere_path_count=world.sphere_path_count + world.sphere_has_path.to(torch.int32),
    )
