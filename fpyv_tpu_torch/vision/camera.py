"""Camera rig: fixed-pitch FPV camera rigidly mounted on the drone frame
(mirrors ``fpyv_tpu.vision.camera``).

Reference parity (src/utils/components.py:449-535):

- mount rotation ``WORLD2CAM.T @ E(deg2rad(pitch), 0, 0)`` (:455);
- ``f = W / (2 tan(fov/2))`` (:470-472), K from f and the half-resolution
  principal point (:468);
- pose update (:501-503): ``cam_pos = p + R @ rel_pos``, ``cam_R = R @ rel_R``;
- ``pixel2direction`` (:505-525) in :mod:`fpyv_tpu_torch.ops.camera_ops`.

``default_vision_rig`` (the JAX package's ``envs.vision_acro``) and
``pixel_ray_grid`` (its ``vision.raycast``) live here, beside the rig, so the
kernel wrappers take them without importing the env or the raycast module.

``K``, ``K_inv`` and ``mount_rotation`` stay float64 numpy host constants:
the kernel wrappers fold them into float32 launch constants.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fpyv_tpu_torch.config import CameraConfig
from fpyv_tpu_torch.ops import rotations as rot
from fpyv_tpu_torch.ops.camera_ops import WORLD2CAM


def _mount_rotation(pitch_deg: float) -> np.ndarray:
    cp, sp = np.cos(np.deg2rad(pitch_deg)), np.sin(np.deg2rad(pitch_deg))
    Ex = np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return WORLD2CAM.T @ Ex


@dataclass(frozen=True)
class CameraRig:
    """Static camera intrinsics and mount (hashable; host-precomputed)."""

    pitch_deg: float = 35.0
    rel_position: Tuple[float, float, float] = (0.1, 0.0, 0.0)
    fov_deg: float = 120.0
    resolution: Tuple[int, int] = (640, 480)  # (W, H)

    @classmethod
    def from_config(cls, cfg: CameraConfig) -> "CameraRig":
        return cls(
            pitch_deg=cfg.camera_angle,
            rel_position=tuple(cfg.position_relative_to_frame),
            fov_deg=cfg.fov,
            resolution=tuple(int(x) for x in cfg.resolution),
        )

    @property
    def focal_length(self) -> float:
        return self.resolution[0] / (2.0 * np.tan(np.deg2rad(self.fov_deg) / 2.0))

    @property
    def K(self) -> np.ndarray:
        f = self.focal_length
        W, H = self.resolution
        return np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])

    @property
    def K_inv(self) -> np.ndarray:
        return np.linalg.inv(self.K)

    @property
    def mount_rotation(self) -> np.ndarray:
        return _mount_rotation(self.pitch_deg)


def default_vision_rig() -> CameraRig:
    """The vision env's rig: params.yaml's FOV, pitch and mount at 96x72."""
    return CameraRig(pitch_deg=35.0, rel_position=(0.1, 0.0, 0.0), fov_deg=120.0,
                     resolution=(96, 72))


def pixel_ray_grid(rig: CameraRig) -> np.ndarray:
    """(3, H, W) float32 camera-frame ray directions through pixel centers,
    z-normalized to 1 (computed in float64, rounded once)."""
    W, H = rig.resolution
    K_inv = rig.K_inv
    u = np.arange(W, dtype=np.float64) + 0.5
    v = np.arange(H, dtype=np.float64) + 0.5
    uu, vv = np.meshgrid(u, v)  # (H, W)
    dx = K_inv[0, 0] * uu + K_inv[0, 1] * vv + K_inv[0, 2]
    dy = K_inv[1, 1] * vv + K_inv[1, 2]
    dz = np.ones_like(dx)
    return np.stack([dx, dy, dz]).astype(np.float32)


@functools.lru_cache(maxsize=32)
def device_mount(rig: CameraRig, device: torch.device,
                 dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rig's ``rel_position`` (3,) and ``mount_rotation`` (3, 3) as
    ``dtype`` tensors on ``device``, made once per rig, device and dtype: a
    pose then waits on no host-to-device copy (read only, shared)."""
    kw = dict(dtype=dtype, device=device)
    return torch.as_tensor(rig.rel_position, **kw), torch.as_tensor(rig.mount_rotation, **kw)


def camera_pose(rig: CameraRig, drone_pos: torch.Tensor, drone_R: torch.Tensor):
    """(cam_pos, cam_R) from the drone pose. Parity: components.py:501-503."""
    rel_p, rel_R = device_mount(rig, drone_pos.device, drone_pos.dtype)
    return drone_pos + rot.mat3_vec(drone_R, rel_p), rot.mat3_mul(drone_R, rel_R)


def pixel_to_direction(rig: CameraRig, cam_R: torch.Tensor, pixel: torch.Tensor):
    """World-frame unit ray through a pixel (components.py:505-525,
    ref_frame='world')."""
    from fpyv_tpu_torch.ops.camera_ops import pixel_to_direction as _p2d

    return _p2d(pixel, rig.K_inv, cam_R)
