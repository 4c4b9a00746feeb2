"""Render point banks: every world object's vertices in one SoA array
(mirrors ``fpyv_tpu.world.render_bank``; host numpy, identical banks).

The reference renders by iterating Python object lists and stacking
``obj.points`` per frame (components.py:537-543). Here all vertices are
concatenated ONCE into a bank with per-point object ids, and each object
declares where its world transform comes from:

- STATIC banks (``build_render_bank``) bake absolute geometry at build time
  (host numpy, exact reference parity); only moving targets stay dynamic —
  they contribute *relative* icosphere vertices plus a center looked up from
  the physics World each frame.
- DYNAMIC banks (``build_dynamic_render_bank``) bake only UNIT geometry;
  position, scale (and rotation, for gates) all come from the World at
  render time. Because World fields broadcast over leading env batches, one
  dynamic bank renders a *different* world per env — the device-side
  counterpart of per-env domain randomization (world/randomize.py), with no
  host rebuilds.

Bank object order mirrors simulator.py:85's object_list:
[targets..., gates..., cylinders..., ground].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from fpyv_tpu_torch.world.generators import (
    WorldSpec,
    cylinder_points,
    gate_corners,
    ground_points,
)
from fpyv_tpu_torch.world.icosphere import icosphere

# obj_pos_source values: which World field positions (and, when
# obj_dynamic_scale, scales/rotates) each object at render time.
SRC_STATIC = 0  # points are world-absolute as baked
SRC_SPHERE = 1  # + world.sphere_center[idx]; scale = sphere_radius[idx]
SRC_CYLINDER = 2  # + world.cyl_center[idx]; scale = (r, r, h)[idx]
SRC_GATE = 3  # gate_rotmat[idx] @ (pts * gate_size[idx]) + gate_pos[idx]


@dataclass(frozen=True)
class RenderBank:
    """Host-built geometry (numpy); wrapped to tensors at the use site."""

    base_points: np.ndarray  # (P, 3) — relative for dynamic objs, else absolute
    point_obj: np.ndarray  # (P,) int32 object index
    obj_pos_source: np.ndarray  # (O,) int32 SRC_* position source
    obj_src_idx: np.ndarray  # (O,) int32 index into the source's World array
    obj_dynamic_scale: np.ndarray  # (O,) bool: scale/rotation from the World
    bbox_base: np.ndarray  # (O, 8, 3) bbox corners of base points
    num_objects: int

    @property
    def num_points(self) -> int:
        return len(self.base_points)

    # -- back-compat views (original field names) --
    @property
    def obj_is_sphere(self) -> np.ndarray:
        return self.obj_pos_source == SRC_SPHERE

    @property
    def obj_sphere_idx(self) -> np.ndarray:
        return np.where(self.obj_is_sphere, self.obj_src_idx, 0).astype(np.int32)

    @property
    def any_dynamic_scale(self) -> bool:
        return bool(self.obj_dynamic_scale.any())

    @property
    def any_dynamic_rot(self) -> bool:
        return bool(
            ((self.obj_pos_source == SRC_GATE) & self.obj_dynamic_scale).any())


def _bbox_corners(points: np.ndarray) -> np.ndarray:
    """8-corner AABB in the reference's corner ordering
    (helper_functions.py:120-136)."""
    mn, mx = points.min(axis=0), points.max(axis=0)
    box = np.zeros((8, 3))
    box[:4, 0] = mn[0]
    box[4:, 0] = mx[0]
    box[::2, 1] = mn[1]
    box[1::2, 1] = mx[1]
    box[[0, 1, 4, 5], 2] = mn[2]
    box[[2, 3, 6, 7], 2] = mx[2]
    return box


class _BankBuilder:
    def __init__(self):
        self.pts, self.obj_ids = [], []
        self.src, self.src_idx, self.dyn, self.bboxes = [], [], [], []
        self.oid = 0

    def add(self, points, source, src_idx, dynamic_scale):
        self.pts.append(points)
        self.obj_ids.append(np.full(len(points), self.oid, np.int32))
        self.src.append(source)
        self.src_idx.append(src_idx)
        self.dyn.append(dynamic_scale)
        self.bboxes.append(_bbox_corners(points))
        self.oid += 1

    def finish(self) -> RenderBank:
        if not self.pts:  # empty world: one inactive dummy point
            self.add(np.zeros((1, 3)), SRC_STATIC, 0, False)
        return RenderBank(
            base_points=np.concatenate(self.pts, axis=0),
            point_obj=np.concatenate(self.obj_ids, axis=0),
            obj_pos_source=np.asarray(self.src, np.int32),
            obj_src_idx=np.asarray(self.src_idx, np.int32),
            obj_dynamic_scale=np.asarray(self.dyn, bool),
            bbox_base=np.stack(self.bboxes, axis=0),
            num_objects=self.oid,
        )


def build_render_bank(spec: WorldSpec,
                      rng: Optional[np.random.Generator] = None) -> RenderBank:
    """Static bank: absolute geometry baked from the spec (reference parity);
    targets keep dynamic centers so CircularPath motion renders."""
    rng = rng or np.random.default_rng(0)
    b = _BankBuilder()

    for si, t in enumerate(spec.targets):
        verts, _ = icosphere(t.nu)
        # scale baked (components.py:758-759); center dynamic (targets move)
        b.add(verts * t.radius, SRC_SPHERE, si, dynamic_scale=False)

    for g in spec.gates:
        corners = gate_corners(g.size, g.shape, g.resolution)
        corners = (g.rotmat @ corners.T).T + g.position  # components.py:803-805
        b.add(corners, SRC_STATIC, 0, dynamic_scale=False)

    for c in spec.cylinders:
        pts = c.position + cylinder_points(
            c.radius, c.height, c.angle_resolution, c.height_resolution,
            c.random, rng)
        b.add(pts, SRC_STATIC, 0, dynamic_scale=False)

    if spec.ground is not None:
        b.add(ground_points(**spec.ground, rng=rng), SRC_STATIC, 0, False)

    return b.finish()


def build_dynamic_render_bank(
    n_spheres: int,
    n_cylinders: int = 0,
    n_gates: int = 0,
    ground: Optional[dict] = None,
    nu: int = 2,
    cyl_angle_resolution: int = 10,
    cyl_height_resolution: int = 10,
    gate_shapes: Tuple[str, ...] = ("rectangle", "circle", "half_circle"),
    gate_resolution: int = 17,
    rng: Optional[np.random.Generator] = None,
) -> RenderBank:
    """Dynamic bank: UNIT geometry only; the World supplies every transform.

    Pair with a batched World (world/randomize.py `sample_worlds`) and the
    renderer draws each env's own randomized world from this ONE shared bank:

        worlds = sample_worlds(generator, n_envs, n_spheres=1, n_cylinders=4)
        bank = build_dynamic_render_bank(1, 4)
        imgs = render_depth_image(rig, cam_pos, cam_R, bank, world=worlds)

    Unit geometry: spheres = nu icosphere (radius 1) scaled by
    world.sphere_radius; cylinders = regular surface grid (radius 1, height
    1, base at z=0) scaled by (cyl_radius, cyl_radius, cyl_height); gates =
    unit-size corner polyline rotated by gate_rotmat and scaled by gate_size
    (gate_corners is linear in size, so unit-scale × size matches the static
    bake to float rounding). Ground stays static (the plane is shared).
    """
    b = _BankBuilder()

    if n_spheres:
        verts, _ = icosphere(nu)
        for si in range(n_spheres):
            b.add(verts, SRC_SPHERE, si, dynamic_scale=True)

    for gi in range(n_gates):
        corners = gate_corners(1.0, gate_shapes[gi % len(gate_shapes)],
                               gate_resolution)
        b.add(corners, SRC_GATE, gi, dynamic_scale=True)

    if n_cylinders:
        unit = cylinder_points(1.0, 1.0, cyl_angle_resolution,
                               cyl_height_resolution, random=False)
        for ci in range(n_cylinders):
            b.add(unit, SRC_CYLINDER, ci, dynamic_scale=True)

    if ground is not None:
        b.add(ground_points(**ground, rng=rng or np.random.default_rng(0)),
              SRC_STATIC, 0, False)

    return b.finish()


def bank_downsample(bank: RenderBank, factor: int,
                    seed: int = 0) -> RenderBank:
    """Keep ~1/factor of each object's points (uniform strided per object).

    The splat renderer's cost is linear in point count, so RL observation
    banks should carry only as many points as the target resolution
    resolves. Bboxes (used for pruning) are preserved from the full geometry.
    """
    if factor <= 1:
        return bank
    keep = np.zeros(bank.num_points, bool)
    for oid in range(bank.num_objects):
        idx = np.nonzero(bank.point_obj == oid)[0]
        keep[idx[::factor]] = True
    return RenderBank(
        base_points=bank.base_points[keep],
        point_obj=bank.point_obj[keep],
        obj_pos_source=bank.obj_pos_source,
        obj_src_idx=bank.obj_src_idx,
        obj_dynamic_scale=bank.obj_dynamic_scale,
        bbox_base=bank.bbox_base,
        num_objects=bank.num_objects,
    )


def bank_subset(bank: RenderBank, obj_indices) -> RenderBank:
    """A bank restricted to the given object indices (e.g. just the chased
    target, like simulator.py:102's render of [targets[idx]])."""
    obj_indices = np.asarray(obj_indices)
    keep = np.isin(bank.point_obj, obj_indices)
    remap = -np.ones(bank.num_objects, np.int32)
    remap[obj_indices] = np.arange(len(obj_indices), dtype=np.int32)
    return RenderBank(
        base_points=bank.base_points[keep],
        point_obj=remap[bank.point_obj[keep]],
        obj_pos_source=bank.obj_pos_source[obj_indices],
        obj_src_idx=bank.obj_src_idx[obj_indices],
        obj_dynamic_scale=bank.obj_dynamic_scale[obj_indices],
        bbox_base=bank.bbox_base[obj_indices],
        num_objects=len(obj_indices),
    )
