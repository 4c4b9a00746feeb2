"""Splat depth renderer: vectorized projection + scatter-min z-buffer
(mirrors ``fpyv_tpu.vision.renderer``; the ``renderer="splat"`` path).

The reference's per-point z-buffer loop (components.py:614-629) as one
batched program:

1. object pruning (components.py:585-600) as a per-object mask: project the
   8 AABB corners, keep objects with any corner in front of the camera and
   an int-truncated 2D bbox overlapping the frame;
2. all bank points project elementwise; pixel ids truncate toward zero like
   the reference's ``astype(int)``;
3. nearest z wins through ``scatter_reduce_(..., "amin")`` into a buffer with
   one spare slot, where out-of-frame and masked points land and drop;
4. empty pixels -> max_depth; output ``255 · (1 - z / max_depth)`` uint8.

Everything batches over leading camera-pose dims (the env axis).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import CameraRig
from fpyv_tpu_torch.world.render_bank import SRC_CYLINDER, SRC_GATE, SRC_SPHERE, RenderBank


def _take(x: torch.Tensor, idx: np.ndarray, n: int, axis: int) -> torch.Tensor:
    """``jnp.take(x, minimum(idx, n - 1), axis)`` for a host index array."""
    i = torch.as_tensor(np.minimum(idx, n - 1), dtype=torch.long, device=x.device)
    return torch.index_select(x, axis % x.ndim, i)


def _object_transforms(bank: RenderBank, world: Optional[World], dtype, device):
    """Per-object world transforms (offset (..., O, 3), scale (..., O, 3) or
    None, rot (..., O, 3, 3) or None); leading dims from batched worlds."""
    if world is None or (bank.obj_pos_source == 0).all():
        return torch.zeros((bank.num_objects, 3), dtype=dtype, device=device), None, None

    src = torch.as_tensor(bank.obj_pos_source, device=device)
    idx = bank.obj_src_idx
    zero = torch.zeros((), dtype=dtype, device=device)

    sph = _take(world.sphere_center.to(dtype), idx, world.num_spheres, -2)
    offset = torch.where((src == SRC_SPHERE)[..., None], sph, zero)
    if (bank.obj_pos_source == SRC_CYLINDER).any():
        cyl = _take(world.cyl_center.to(dtype), idx, world.num_cylinders, -2)
        offset = torch.where((src == SRC_CYLINDER)[..., None], cyl, offset)
    if (bank.obj_pos_source == SRC_GATE).any():
        gat = _take(world.gate_pos.to(dtype), idx, world.num_gates, -2)
        offset = torch.where((src == SRC_GATE)[..., None], gat, offset)

    scale = rot = None
    if bank.any_dynamic_scale:
        dyn = torch.as_tensor(bank.obj_dynamic_scale, device=device)
        one = torch.ones((), dtype=dtype, device=device)
        r_s = _take(world.sphere_radius.to(dtype), idx, world.num_spheres, -1)
        sx = sy = sz = torch.where(dyn & (src == SRC_SPHERE), r_s, one)
        if (bank.obj_pos_source == SRC_CYLINDER).any():
            r_c = _take(world.cyl_radius.to(dtype), idx, world.num_cylinders, -1)
            h_c = _take(world.cyl_height.to(dtype), idx, world.num_cylinders, -1)
            is_cyl = dyn & (src == SRC_CYLINDER)
            sx = torch.where(is_cyl, r_c, sx)
            sy = torch.where(is_cyl, r_c, sy)
            sz = torch.where(is_cyl, h_c, sz)
        if (bank.obj_pos_source == SRC_GATE).any():
            g_s = _take(world.gate_size.to(dtype), idx, world.num_gates, -1)
            is_gate = dyn & (src == SRC_GATE)
            sx = torch.where(is_gate, g_s, sx)
            sy = torch.where(is_gate, g_s, sy)
            sz = torch.where(is_gate, g_s, sz)
        scale = torch.stack(torch.broadcast_tensors(sx, sy, sz), dim=-1)
    if bank.any_dynamic_rot:
        g_R = _take(world.gate_rotmat.to(dtype), idx, world.num_gates, -3)
        eye = torch.eye(3, dtype=dtype, device=device)
        is_gate = (torch.as_tensor(bank.obj_dynamic_scale, device=device)
                   & (src == SRC_GATE))[..., None, None]
        rot = torch.where(is_gate, g_R, eye)
    return offset, scale, rot


def _apply_transform(pts, offset, scale, rot):
    """Scale, rotate, translate (each aligned to the point axis; None =
    identity), elementwise."""
    if scale is not None:
        pts = pts * scale
    if rot is not None:
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        pts = torch.stack([
            rot[..., 0, 0] * x + rot[..., 0, 1] * y + rot[..., 0, 2] * z,
            rot[..., 1, 0] * x + rot[..., 1, 1] * y + rot[..., 1, 2] * z,
            rot[..., 2, 0] * x + rot[..., 2, 1] * y + rot[..., 2, 2] * z,
        ], dim=-1)
    return pts + offset


def _bank_geometry(rig, cam_pos, cam_R, bank: RenderBank, world, obj_active, prune: bool):
    """World-space bank points + per-point validity."""
    dtype, device = cam_pos.dtype, cam_pos.device
    base = torch.as_tensor(bank.base_points, dtype=dtype, device=device)
    point_obj = torch.as_tensor(bank.point_obj, dtype=torch.long, device=device)
    offset, scale, rot = _object_transforms(bank, world, dtype, device)
    points = _apply_transform(
        base,
        offset[..., point_obj, :],
        None if scale is None else scale[..., point_obj, :],
        None if rot is None else rot[..., point_obj, :, :],
    )
    keep = torch.ones((bank.num_objects,), dtype=torch.bool, device=device)
    if obj_active is not None:
        keep = keep & torch.as_tensor(obj_active, device=device)
    if prune:
        bbox_world = _apply_transform(
            torch.as_tensor(bank.bbox_base, dtype=dtype, device=device),
            offset[..., :, None, :],
            None if scale is None else scale[..., :, None, :],
            None if rot is None else rot[..., :, None, :, :],
        )
        keep = keep & prune_objects(rig, cam_pos, cam_R, bbox_world)
    return points, keep[..., point_obj]


def _project(cam_pos, cam_R, K, points):
    """points (..., P, 3) -> float pixels u, v and camera depth (..., P),
    written out per component (``R.T @ (p - t)``, then K)."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    rx = px - cam_pos[..., 0, None]
    ry = py - cam_pos[..., 1, None]
    rz = pz - cam_pos[..., 2, None]
    cx = cam_R[..., 0, 0, None] * rx + cam_R[..., 1, 0, None] * ry + cam_R[..., 2, 0, None] * rz
    cy = cam_R[..., 0, 1, None] * rx + cam_R[..., 1, 1, None] * ry + cam_R[..., 2, 1, None] * rz
    cz = cam_R[..., 0, 2, None] * rx + cam_R[..., 1, 2, None] * ry + cam_R[..., 2, 2, None] * rz
    fx, fy = K[0, 0], K[1, 1]
    cx0, cy0 = K[0, 2], K[1, 2]
    safe = torch.where(torch.abs(cz) > 1e-20, cz, torch.full_like(cz, 1e-20))
    return fx * cx / safe + cx0, fy * cy / safe + cy0, cz


def _K(rig: CameraRig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rig.K, dtype=like.dtype, device=like.device)


def prune_objects(rig: CameraRig, cam_pos, cam_R, bbox_world):
    """Per-object keep mask (..., O) from bbox corners (..., O, 8, 3).
    Parity: components.py:585-600."""
    W, H = rig.resolution
    O = bbox_world.shape[-3]
    flat = bbox_world.reshape(bbox_world.shape[:-3] + (O * 8, 3))
    u, v, depth = _project(cam_pos, cam_R, _K(rig, cam_pos), flat)
    lead = depth.shape[:-1]
    u = torch.trunc(u).reshape(lead + (O, 8))
    v = torch.trunc(v).reshape(lead + (O, 8))
    front = (depth > 0).reshape(lead + (O, 8))
    any_front = front.any(-1)
    inf = torch.tensor(float("inf"), dtype=u.dtype, device=u.device)
    min_u = torch.where(front, u, inf).amin(-1)
    min_v = torch.where(front, v, inf).amin(-1)
    max_u = torch.where(front, u, -inf).amax(-1)
    max_v = torch.where(front, v, -inf).amax(-1)
    overlap = (max_u > 0) & (max_v > 0) & (min_u < W) & (min_v < H)
    return any_front & overlap


def _splat_min(rig: CameraRig, u, v, depth, valid):
    """Nearest-z scatter into the (H, W) buffer; invalid points drop."""
    W, H = rig.resolution
    ui = torch.trunc(u).to(torch.int64)
    vi = torch.trunc(v).to(torch.int64)
    in_frame = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ok = valid & in_frame & (depth > 0)
    idx = torch.where(ok, vi * W + ui, torch.full_like(ui, H * W))  # slot H*W drops
    lead = depth.shape[:-1]
    flat_i = torch.broadcast_to(idx, depth.shape).reshape(-1, depth.shape[-1])
    flat_d = depth.reshape(-1, depth.shape[-1])
    buf = torch.full((flat_d.shape[0], H * W + 1), float("inf"), dtype=depth.dtype,
                     device=depth.device)
    buf.scatter_reduce_(1, flat_i, flat_d, reduce="amin", include_self=True)
    return buf[:, :H * W].reshape(lead + (H, W))


def render_depth_image(
    rig: CameraRig,
    cam_pos: torch.Tensor,  # (..., 3)
    cam_R: torch.Tensor,  # (..., 3, 3)
    bank: RenderBank,
    world: Optional[World] = None,  # for moving-sphere positions
    max_depth: float = 10.0,
    obj_active: Optional[torch.Tensor] = None,  # (O,) bool extra mask
    prune: bool = True,
) -> torch.Tensor:
    """uint8 depth image(s) (..., H, W). Parity: components.py:614-629."""
    points, valid = _bank_geometry(rig, cam_pos, cam_R, bank, world, obj_active, prune)
    u, v, depth = _project(cam_pos, cam_R, _K(rig, cam_pos), points)
    img = _splat_min(rig, u, v, depth, valid)
    img = torch.clamp_max(img, max_depth)  # clip + empty (inf) -> max_depth in one
    return (255.0 * (1.0 - img / max_depth)).to(torch.uint8)


def render_binary_image(
    rig: CameraRig,
    cam_pos: torch.Tensor,
    cam_R: torch.Tensor,
    bank: RenderBank,
    world: Optional[World] = None,
    obj_active: Optional[torch.Tensor] = None,
    prune: bool = True,
) -> torch.Tensor:
    """Binary hit image (..., H, W) float32 {0, 1}. Parity: components.py:602-612."""
    points, valid = _bank_geometry(rig, cam_pos, cam_R, bank, world, obj_active, prune)
    u, v, depth = _project(cam_pos, cam_R, _K(rig, cam_pos), points)
    img = _splat_min(rig, u, v, depth, valid)
    return torch.isfinite(img).to(torch.float32)


def project_point_pixel(rig: CameraRig, cam_pos, cam_R, point):
    """Analytic pixel of one world point: ((..., 2) float [u, v], (...,) bool
    in-frustum). The closed-form twin of :func:`target_pixel_centroid` for a
    full-world image, where a centroid would not isolate the target."""
    u, v, cz = _project(cam_pos, cam_R, _K(rig, point), point[..., None, :])
    u, v, cz = u[..., 0], v[..., 0], cz[..., 0]
    W, H = rig.resolution
    visible = (cz > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return torch.stack([u, v], dim=-1), visible


def target_pixel_centroid(depth_img: torch.Tensor):
    """Mean (u, v) of lit pixels — the reference's target-pixel extraction
    (simulator.py:103-107: ``np.where(img > 0).mean`` with [v, u] -> [u, v]).
    Returns ((..., 2) float centroid, (...,) bool found)."""
    lit = depth_img > 0
    H, W = depth_img.shape[-2:]
    vs = torch.arange(H, dtype=torch.float32, device=depth_img.device)[:, None]
    us = torch.arange(W, dtype=torch.float32, device=depth_img.device)[None, :]
    count = lit.sum(dim=(-2, -1))
    safe = torch.clamp_min(count, 1)
    u_mean = (lit * us).sum(dim=(-2, -1)) / safe
    v_mean = (lit * vs).sum(dim=(-2, -1)) / safe
    return torch.stack([u_mean, v_mean], dim=-1), count > 0
