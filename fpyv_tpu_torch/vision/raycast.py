"""Analytic raycast depth renderer: ray-primitive intersection per pixel
(mirrors ``fpyv_tpu.vision.raycast``; the ``renderer="raycast"`` path).

Every world primitive has a closed-form ray intersection, so a depth image
is elementwise math over the pixel grid: spheres as filled disks, cylinders
as open tubes, the ground plane, gates as thin shape-aware frames. Depth is
camera z: rays are ``p = cam_pos + t · d_world`` with
``d_cam = K^-1 [u + .5, v + .5, 1]`` (z = 1), so the hit's camera z is t.
The uint8 encoding is the splat renderer's ``255 · (1 - z / max_depth)``
(components.py:626-628).

The math is K5's (:mod:`fpyv_tpu_torch.ops.vision_kernel`), in float32:
``raycast_depth`` is its plain version's raw nearest hit, and
``render_depth_raycast`` its levels, launched as the kernel on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.ops.vision_kernel import (  # noqa: F401  (_BIG: the JAX module's name)
    _BIG,
    frame_shape,
    fused_render_depth,
    render_inputs,
    render_tiles,
)
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import CameraRig, pixel_ray_grid  # noqa: F401

ALL = ("spheres", "cylinders", "ground", "gates")


def raycast_depth(
    rig: CameraRig,
    cam_pos: torch.Tensor,  # (..., 3)
    cam_R: torch.Tensor,  # (..., 3, 3)
    world: World,
    include: Tuple[str, ...] = ALL,
    ground_extent: Optional[float] = None,
    frame_width: float = 0.08,
) -> torch.Tensor:
    """Raw nearest-hit camera-z depth (..., H, W) float32; _BIG where empty."""
    cfg, dcam, cam, wcol = render_inputs(rig, cam_pos, cam_R, world, 1.0, include,
                                         ground_extent, frame_width)
    return render_tiles(cfg, dcam, cam, wcol).reshape(frame_shape(rig, cam_pos))


def render_depth_raycast(
    rig: CameraRig,
    cam_pos: torch.Tensor,
    cam_R: torch.Tensor,
    world: World,
    max_depth: float = 10.0,
    include: Tuple[str, ...] = ALL,
    ground_extent: Optional[float] = None,
    frame_width: float = 0.08,
) -> torch.Tensor:
    """uint8 depth image(s) (..., H, W), the splat renderer's encoding
    (components.py:626-628): empty -> max_depth, ``255 · (1 - z / max_depth)``."""
    frames = fused_render_depth(rig, cam_pos, cam_R, world, max_depth, include,
                                ground_extent, frame_width)
    return torch.round(frames * 255.0).to(torch.uint8)
