"""Pinhole camera math: intrinsics, FOV <-> focal length, projection
(mirrors ``fpyv_tpu.ops.camera_ops``).

Reference parity (src/utils/helper_functions.py, src/utils/components.py):

- ``WORLD2CAM`` axis permutation (helper_functions.py:7-9): world xyz to
  camera uvw — u=y, v=-z, w=x.
- ``intrinsic_matrix`` (helper_functions.py:11-12).
- focal length from the *horizontal* FOV: ``f = W / (2 tan(fov/2))``
  (components.py:470-472).
- projection (components.py:531-535, 545-568) without forming the 4x4
  inverse: ``p_cam = R.T @ (p - t)``.

Products are written out elementwise rather than as matmuls, so a float32
chain never runs through TF32 on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device

# World xyz -> camera uvw permutation (helper_functions.py:7-9).
WORLD2CAM = np.array(
    [
        [0.0, 1.0, 0.0],
        [0.0, 0.0, -1.0],
        [1.0, 0.0, 0.0],
    ]
)


def intrinsic_matrix(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    """K matrix (..., 3, 3) on ``device`` (CUDA unless told). Parity:
    helper_functions.py:11-12."""
    device = resolve_device(device)
    fx = torch.as_tensor(fx, dtype=dtype, device=device)
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    kw = dict(dtype=dtype, device=device)
    return torch.stack([
        torch.stack([fx, z, torch.as_tensor(cx, **kw) * o], dim=-1),
        torch.stack([z, torch.as_tensor(fy, **kw) * o, torch.as_tensor(cy, **kw) * o], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def focal_length_from_fov(fov_deg, width):
    """f = W / (2 tan(fov/2)). Parity: components.py:470-472."""
    if isinstance(fov_deg, torch.Tensor):
        return width / (2.0 * torch.tan(torch.deg2rad(fov_deg) / 2.0))
    return width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))


def fov_from_focal_length(focal_length, width):
    """Parity: components.py:474-475."""
    if isinstance(focal_length, torch.Tensor):
        return torch.rad2deg(2.0 * torch.atan(width / (2.0 * focal_length)))
    return math.degrees(2.0 * math.atan(width / (2.0 * focal_length)))


def fovs_from_resolution(resolution, focal_length):
    """(horizontal, vertical) FOV in degrees. Parity: components.py:477-488."""
    w, h = resolution[0], resolution[1]
    return (math.degrees(2.0 * math.atan2(w / 2.0, focal_length)),
            math.degrees(2.0 * math.atan2(h / 2.0, focal_length)))


def world_to_camera(points: torch.Tensor, cam_R: torch.Tensor, cam_t: torch.Tensor):
    """World points (..., P, 3) into the camera frame: ``R.T @ (p - t)``
    (components.py:531-535); cam_R (..., 3, 3) camera-to-world, cam_t (..., 3)."""
    rel = points - cam_t[..., None, :]
    R = cam_R[..., None, :, :]
    return (R[..., 0, :] * rel[..., 0:1] + R[..., 1, :] * rel[..., 1:2]
            + R[..., 2, :] * rel[..., 2:3])


def project_camera_points(pts_cam: torch.Tensor, K, eps: float = 1e-12):
    """Intrinsics and perspective divide: (u, v, depth), each (..., P).
    Parity with components.py:545-568 up to the int cast."""
    K = torch.as_tensor(K, dtype=pts_cam.dtype, device=pts_cam.device)
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    xs = [K[..., i, 0, None] * x + K[..., i, 1, None] * y + K[..., i, 2, None] * z
          for i in range(3)]
    depth = xs[2]
    safe = torch.where(torch.abs(depth) > eps, depth, torch.full_like(depth, eps))
    return xs[0] / safe, xs[1] / safe, depth


def pixel_to_direction(pixel: torch.Tensor, K_inv, cam_R=None) -> torch.Tensor:
    """Unit ray through a pixel (components.py:505-525, ``pixel2direction``):
    ``dir = R_cam @ K^-1 @ [px, py, 1]``, normalized; camera frame when
    ``cam_R`` is None."""
    Ki = torch.as_tensor(np.asarray(K_inv), dtype=pixel.dtype, device=pixel.device)
    ph = torch.cat([pixel, torch.ones_like(pixel[..., :1])], dim=-1)
    d = torch.stack([(Ki[i] * ph).sum(-1) for i in range(3)], dim=-1)
    if cam_R is not None:
        d = torch.stack([(cam_R[..., i, :] * d).sum(-1) for i in range(3)], dim=-1)
    return d / torch.clamp_min(torch.linalg.vector_norm(d, dim=-1, keepdim=True), 1e-12)


def bbox3d_corners(points: torch.Tensor, mask=None) -> torch.Tensor:
    """8 corners of the axis-aligned bounding box of (..., P, 3) points, in
    the reference's corner order (helper_functions.py:120-136): corner i has
    x = max if i >= 4, y = max if i is odd, z = max if i in {2, 3, 6, 7}."""
    if mask is not None:
        big = torch.tensor(float("inf"), dtype=points.dtype, device=points.device)
        mn = torch.where(mask[..., None], points, big).amin(-2)
        mx = torch.where(mask[..., None], points, -big).amax(-2)
    else:
        mn, mx = points.amin(-2), points.amax(-2)
    sel = torch.tensor([[0, 0, 0], [0, 1, 0], [0, 0, 1], [0, 1, 1],
                        [1, 0, 0], [1, 1, 0], [1, 0, 1], [1, 1, 1]],
                       dtype=points.dtype, device=points.device)
    return mn[..., None, :] * (1.0 - sel) + mx[..., None, :] * sel
