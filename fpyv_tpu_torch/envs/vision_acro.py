"""Vision-based acro env: depth-image pixel observations for RL (mirrors
``fpyv_tpu.envs.vision_acro``).

Wraps :class:`fpyv_tpu_torch.envs.acro.AcroEnv` with the FPV camera rig
rendering after each step: the reference's dim==2 loop (simulator.py:115-168,
render_depth_image of the world and the chased target, HUD aside). The
default rig renders at 96x72 with params.yaml's FOV, pitch and mount.

Renderers:

- ``"splat"``: the reference-parity point z-buffer
  (:mod:`fpyv_tpu_torch.vision.renderer`);
- ``"raycast"`` and ``"raycast_pallas"``: analytic ray-primitive depths,
  solid silhouettes, same geometry, as one kernel launch, K5
  (:func:`fpyv_tpu_torch.ops.vision_kernel.fused_render_depth`): the
  hand-written CUDA kernel on a CUDA state and its plain PyTorch version on
  a CPU state. The JAX package has a plain raycast and a Pallas one, whose
  levels are equal; both names are kept so configs carry over, and here
  both run K5.

Where the JAX env vmaps over PRNG keys, the batched entry points here take
one ``torch.Generator`` and the number of envs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.acro import AcroEnv, AcroState
from fpyv_tpu_torch.envs.base import Part
from fpyv_tpu_torch.physics.drone import DroneParams, _att_to_rotmat
from fpyv_tpu_torch.ops.vision_kernel import fused_render_depth
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import (  # noqa: F401  (default_vision_rig: the JAX module's name)
    CameraRig,
    camera_pose,
    default_vision_rig,
)
from fpyv_tpu_torch.vision.renderer import (
    project_point_pixel,
    render_depth_image,
    target_pixel_centroid,
)
from fpyv_tpu_torch.world.generators import WorldSpec, build_world
from fpyv_tpu_torch.world.render_bank import (
    RenderBank,
    bank_subset,
    build_dynamic_render_bank,
    build_render_bank,
)


@dataclass(frozen=True)
class VisionAcroEnv:
    """Acro env whose observation is {pixels, imu} instead of ground truth."""

    acro: AcroEnv = field(default_factory=AcroEnv)
    rig: CameraRig = field(default_factory=default_vision_rig)
    max_depth: float = 25.0  # simulator.py:121's render_depth_image max_depth
    # render only the chased target, as the reference's FPV chase loop does
    # (simulator.py:102/127)
    target_only: bool = True
    renderer: str = "splat"  # "splat" | "raycast" | "raycast_pallas" (module note)
    # half-extent (m) clipping the raycast ground to the splat ground cloud's
    # footprint; None = infinite plane
    ground_extent: Optional[float] = None
    frame_width: float = 0.08  # gate-frame band half-width (m) of the raycasts
    # "f32" = levels / 255; "u8" = the raw uint8 levels (a quarter of the bytes)
    pixel_dtype: str = "f32"

    def __post_init__(self):
        if self.renderer not in ("splat", "raycast", "raycast_pallas"):
            raise ValueError("renderer must be 'splat', 'raycast' or 'raycast_pallas', "
                             f"got {self.renderer!r}")
        if self.pixel_dtype not in ("f32", "u8"):
            raise ValueError(f"pixel_dtype must be 'f32' or 'u8', got {self.pixel_dtype!r}")

    @property
    def params(self) -> DroneParams:
        return self.acro.params

    def make_world(self, spec: Optional[WorldSpec] = None, seed: int = 0,
                   device=None) -> Tuple[World, RenderBank]:
        """The world on ``device`` (CUDA unless told) and its render bank;
        params.yaml's world when ``spec`` is None."""
        if spec is None:
            from fpyv_tpu_torch.config import FpyvConfig

            spec = WorldSpec.from_config(FpyvConfig().simulator, seed=seed)
        bank = build_render_bank(spec)
        if self.target_only and spec.targets:
            bank = bank_subset(bank, [0])  # bank order: [targets..., ...]
        return build_world(spec, dtype=self.acro.dtype, device=device), bank

    def make_randomized_worlds(self, generator: torch.Generator, n_envs: int,
                               n_spheres: int = 1, n_cylinders: int = 4, device=None,
                               **sample_kwargs) -> Tuple[World, RenderBank]:
        """Per-env randomized worlds on ``device`` (CUDA unless told) and ONE
        shared dynamic render bank whose transforms are read from the
        batched World at render time."""
        from fpyv_tpu_torch.world.randomize import sample_worlds

        worlds = sample_worlds(generator, n_envs, n_spheres=n_spheres, n_cylinders=n_cylinders,
                               dtype=self.acro.dtype, device=resolve_device(device),
                               **sample_kwargs)
        if self.target_only:
            bank = build_dynamic_render_bank(n_spheres=1, n_cylinders=0, ground=None)
        else:
            bank = build_dynamic_render_bank(n_spheres=n_spheres, n_cylinders=n_cylinders,
                                             ground=None)
        return worlds, bank

    def _camera(self, state: AcroState):
        R = _att_to_rotmat(self.params, state.drone.att)
        return camera_pose(self.rig, state.drone.pos, R)

    def _render(self, state: AcroState, world: World, bank: RenderBank):
        cam_pos, cam_R = self._camera(state)
        if self.renderer in ("raycast", "raycast_pallas"):
            include = ("spheres", "cylinders", "ground", "gates")
            if self.target_only:  # chased target (sphere 0) only
                include = ("spheres",)
                mask = torch.zeros_like(world.sphere_active)
                mask[..., 0] = True
                world = world.replace(sphere_active=world.sphere_active & mask)
            return fused_render_depth(self.rig, cam_pos, cam_R, world, max_depth=self.max_depth,
                                      include=include, ground_extent=self.ground_extent,
                                      frame_width=self.frame_width)
        return render_depth_image(self.rig, cam_pos, cam_R, bank, world=world,
                                  max_depth=self.max_depth)

    def _obs(self, state: AcroState, world: World, bank: RenderBank):
        img = self._render(state, world, bank)
        # splat emits uint8 images; K5 emits the same levels already as
        # floats in [0, 1]
        if self.pixel_dtype == "u8":
            pixels = (torch.round(img * 255.0).to(torch.uint8) if img.is_floating_point()
                      else img)
        elif img.is_floating_point():
            pixels = img.to(self.acro.dtype)
        else:
            pixels = img.to(self.acro.dtype) / 255.0
        return {
            "pixels": pixels,
            "rates": state.drone.rates / self.params.max_rates,
            "accel_z": state.drone.accel[..., 2:3] / 30.0,
            "thrust": state.drone.thrust[..., None] / self.params.thrust_curve.max_force,
        }

    def _target_info(self, state: AcroState, world: World, obs, info):
        """The target pixel: the centroid of the target-only depth image, as
        the reference's chase loop extracts it (simulator.py:103-107), or the
        chased sphere's projected center when the image holds the world."""
        if self.target_only:
            px = obs["pixels"]
            lit = px if px.dtype == torch.uint8 else (px * 255.0).to(torch.uint8)
            centroid, found = target_pixel_centroid(lit)
        else:
            cam_pos, cam_R = self._camera(state)
            centroid, found = project_point_pixel(self.rig, cam_pos, cam_R,
                                                  world.sphere_center[..., 0, :])
        return dict(info, target_pixel=centroid, target_visible=found)

    def reset(self, generator: torch.Generator, world: World, bank: RenderBank,
              batch_shape=()):
        state, _ = self.acro.reset(generator, world, batch_shape)
        return state, self._obs(state, world, bank)

    def step(self, state: AcroState, action, world: World, bank: RenderBank, wind=None,
             generator: Optional[torch.Generator] = None, part: Optional[Part] = None):
        """``AcroEnv.step`` and the render; ``part`` as there."""
        state, _, reward, done, info = self.acro.step(state, action, world, wind, generator,
                                                      part=part)
        obs = self._obs(state, world, bank)
        return state, obs, reward, done, self._target_info(state, world, obs, info)

    # -- batched entry points: the whole env bank renders in ONE call (one
    # kernel launch for the raycast renderers)

    def reset_batched(self, generator: torch.Generator, world: World, bank: RenderBank,
                      n_envs: int):
        """``n_envs`` fresh envs on a shared or per-env batched world."""
        return self.reset(generator, world, bank, (n_envs,))

    def step_batched(self, state: AcroState, action, world: World, bank: RenderBank,
                     wind=None, generator: Optional[torch.Generator] = None,
                     part: Optional[Part] = None):
        return self.step(state, action, world, bank, wind, generator, part)
