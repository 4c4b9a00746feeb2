"""Vision kernels: K5, the batched raycast depth render, and K6, the FPV
chase megaloop, as CUDA kernels with their plain PyTorch versions (mirrors
``fpyv_tpu.ops.pallas_vision``).

- :func:`fused_render_depth` (``pallas_render_depth``): depth frames
  (N, H, W) float32 in [0, 1], quantised to the uint8 levels the splat and
  raycast renderers emit, ``floor(255 (1 - t / max_depth)) / 255``.
- :func:`fused_vision_env_rollout` (``pallas_vision_env_rollout``): K steps
  of the chase loop in one launch. Each step renders the chased target
  (sphere 0) alone, over the pixels that :func:`target_pixel_box` says it
  can light on the card (the plain version renders the full frame; both
  give the same mask), takes the mask centroid, runs the guidance pilot
  (:class:`ChasePilot`) and applies its attitude and |F| through the physics
  override, then the full acro env step of K4 (reward, auto-reset,
  CircularPath targets, DomainRand and wind). The PID memory rides in four
  rows after the 24 env rows, zeroed at every launch and on every reset.

Layouts: a camera is a row of 16 floats (position, rotation row major,
padding); a world is a row of columns per env (``world_cols``), one row for
a shared world; the ray grid ``dcam`` is (3, H*W) in pixel order v*W + u.
The chase state is the (28, N) matrix of K4's 24 rows plus the PID rows.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel, and
anything the kernel does not take raises.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.envs.acro import AcroEnv, AcroState
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops.env_kernel import (
    ENV_ROWS,
    MAX_STEPS_PER_LAUNCH,
    WORLD_ROWS,
    env_constants,
    env_constants_array,
    env_rollout_reference,
    env_state_to_matrix,
    env_supported,
    env_world_matrix,
    matrix_to_env_state,
)
from fpyv_tpu_torch.ops.step_kernel import (
    _f32,
    check_cuda_inputs,
    cylinder_matrix,
    step_constants_array,
    world_has_cylinders,
)
from fpyv_tpu_torch.physics.drone import DroneParams
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.vision.camera import CameraRig, default_vision_rig, pixel_ray_grid

_BIG = 3.0e38  # "no hit" sentinel, < float32 inf so min/where stay finite
CAM_COLS = 16
N_PILOT_ROWS = 4  # PID memory: integral, prev_derivative, previous_error, started
CH_ROWS = ENV_ROWS + N_PILOT_ROWS


def flat_dcam(rig: CameraRig) -> np.ndarray:
    """(3, H*W) float32 camera-frame ray directions, pixel order v*W + u."""
    return pixel_ray_grid(rig).reshape(3, -1)


@functools.lru_cache(maxsize=16)
def device_dcam(rig: CameraRig, device: torch.device) -> torch.Tensor:
    """:func:`flat_dcam` on ``device``, made once per rig and device: a
    launch then neither rebuilds the grid nor waits on a host-to-device copy
    (read only)."""
    return torch.from_numpy(flat_dcam(rig)).to(device)


# ---------------------------------------------------------------------------
# K5: configuration and layouts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RenderConfig:
    """Static render configuration, in the order of ``RenderConsts`` in
    ``csrc/render.cuh``."""

    n_spheres: int
    n_cylinders: int
    n_gates: int
    spheres: bool
    cylinders: bool
    ground: bool
    gates: bool
    max_depth: float
    ground_extent: Optional[float] = None
    frame_width: float = 0.08

    @classmethod
    def for_world(cls, world: World, max_depth: float,
                  include=("spheres", "cylinders", "ground", "gates"),
                  ground_extent: Optional[float] = None,
                  frame_width: float = 0.08) -> "RenderConfig":
        return cls(n_spheres=world.num_spheres, n_cylinders=world.num_cylinders,
                   n_gates=world.num_gates, spheres="spheres" in include,
                   cylinders="cylinders" in include, ground="ground" in include,
                   gates="gates" in include, max_depth=float(max_depth),
                   ground_extent=None if ground_extent is None else float(ground_extent),
                   frame_width=float(frame_width))

    @property
    def n_cols(self) -> int:
        return 5 * self.n_spheres + 6 * self.n_cylinders + 15 * self.n_gates + 1

    def as_array(self) -> np.ndarray:
        clip = self.ground_extent is not None
        return np.asarray([self.n_spheres, self.n_cylinders, self.n_gates, self.spheres,
                           self.cylinders, self.ground, self.gates, self.max_depth, clip,
                           self.ground_extent if clip else 0.0, self.frame_width], np.float32)


def world_batched(world: World) -> bool:
    return world.sphere_center.ndim == 3


def world_cols(world: World) -> torch.Tensor:
    """(N, n_cols) float32 per-env world columns for a batched world, (1,
    n_cols) for a shared one (``pallas_vision._world_cols``): spheres
    s*5 + [cx cy cz r active], cylinders 5S + c*6 + [cx cy cz r h active],
    gates 5S + 6C + g*15 + [pos normal ey ez size active shape], ground last."""
    n = world.sphere_center.shape[0] if world_batched(world) else 1

    def vec(x):  # (..., K, 3) -> (n, K, 3)
        return x.to(torch.float32).reshape(n, -1, 3)

    def scal(x):  # (..., K) -> (n, K, 1)
        return x.to(torch.float32).reshape(n, -1, 1)

    R = world.gate_rotmat.to(torch.float32).reshape(n, -1, 3, 3)
    blocks = [
        [vec(world.sphere_center), scal(world.sphere_radius), scal(world.sphere_active)],
        [vec(world.cyl_center), scal(world.cyl_radius), scal(world.cyl_height),
         scal(world.cyl_active)],
        [vec(world.gate_pos), R[..., :, 0], R[..., :, 1], R[..., :, 2], scal(world.gate_size),
         scal(world.gate_active), scal(world.gate_shape)],
    ]
    return torch.cat([torch.cat(b, dim=-1).reshape(n, -1) for b in blocks]
                     + [world.has_ground.to(torch.float32).reshape(n, 1)], dim=1).contiguous()


def camera_matrix(cam_pos: torch.Tensor, cam_R: torch.Tensor) -> torch.Tensor:
    """(N, 16) camera rows: position, rotation row major, zero padding."""
    n = cam_pos.shape[0]
    return torch.cat([cam_pos.to(torch.float32), cam_R.reshape(n, 9).to(torch.float32),
                      torch.zeros(n, CAM_COLS - 12, dtype=torch.float32,
                                  device=cam_pos.device)], dim=1).contiguous()


# ---------------------------------------------------------------------------
# K5: plain PyTorch version
# ---------------------------------------------------------------------------


def _sphere_t(a, ox, oy, oz, r, act, dwx, dwy, dwz, big):
    b = ox * dwx + oy * dwy + oz * dwz
    c = ox * ox + oy * oy + oz * oz - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t = (-b - sq) / a
    t = torch.where(t > 0, t, (-b + sq) / a)
    ok = (disc >= 0) & (t > 0) & act
    return torch.where(ok, t, big)


def render_tiles(cfg: RenderConfig, dcam: torch.Tensor, cam: torch.Tensor,
                 wcol: torch.Tensor) -> torch.Tensor:
    """Nearest-hit t (N, H*W), line by line as
    ``pallas_vision._render_tiles``; ``wcol`` rows broadcast over envs."""
    def col(m, j):
        return m[:, j:j + 1]

    dxr, dyr, dzr = dcam[0:1], dcam[1:2], dcam[2:3]
    px, py, pz = col(cam, 0), col(cam, 1), col(cam, 2)
    R = [col(cam, 3 + k) for k in range(9)]
    dwx = R[0] * dxr + R[1] * dyr + R[2] * dzr
    dwy = R[3] * dxr + R[4] * dyr + R[5] * dzr
    dwz = R[6] * dxr + R[7] * dyr + R[8] * dzr

    big = torch.tensor(_BIG, dtype=torch.float32, device=cam.device)
    t_min = torch.full(dwx.shape, _BIG, dtype=torch.float32, device=cam.device)
    S, C, G = cfg.n_spheres, cfg.n_cylinders, cfg.n_gates
    off_c = S * 5
    off_g = off_c + C * 6

    if cfg.spheres:
        a = dwx * dwx + dwy * dwy + dwz * dwz
        for s in range(S):
            o = s * 5
            t_min = torch.minimum(t_min, _sphere_t(
                a, px - col(wcol, o), py - col(wcol, o + 1), pz - col(wcol, o + 2),
                col(wcol, o + 3), col(wcol, o + 4) > 0.5, dwx, dwy, dwz, big))

    if cfg.cylinders:
        a2 = dwx * dwx + dwy * dwy
        safe_a = torch.where(torch.abs(a2) > 1e-20, a2, torch.full_like(a2, 1e-20))
        for ci in range(C):
            o = off_c + ci * 6
            ox, oy = px - col(wcol, o), py - col(wcol, o + 1)
            z0, r, h = col(wcol, o + 2), col(wcol, o + 3), col(wcol, o + 4)
            b = ox * dwx + oy * dwy
            c = ox * ox + oy * oy - r * r
            disc = b * b - a2 * c
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            hit_any = torch.zeros(dwx.shape, dtype=torch.bool, device=cam.device)
            t_cyl = torch.full_like(dwx, _BIG)
            for sign in (-1.0, 1.0):  # near wall, then far wall
                t = (-b + sign * sq) / safe_a
                zhit = pz + t * dwz
                ok = (disc >= 0) & (t > 0) & (zhit >= z0) & (zhit <= z0 + h)
                t_cyl = torch.where(ok & ~hit_any, t, t_cyl)
                hit_any = hit_any | ok
            hit_any = hit_any & (col(wcol, o + 5) > 0.5)
            t_min = torch.minimum(t_min, torch.where(hit_any, t_cyl, big))

    if cfg.ground:
        has = col(wcol, off_g + G * 15) > 0.5
        safe = torch.where(torch.abs(dwz) > 1e-20, dwz, torch.full_like(dwz, 1e-20))
        t = -pz / safe
        ok = (t > 0) & (torch.abs(dwz) > 1e-20) & has
        if cfg.ground_extent is not None:
            ext = _f32(cfg.ground_extent)
            ok = ok & (torch.abs(px + t * dwx) <= ext) & (torch.abs(py + t * dwy) <= ext)
        t_min = torch.minimum(t_min, torch.where(ok, t, big))

    if cfg.gates:
        fw = _f32(cfg.frame_width)
        for g in range(G):
            q = [col(wcol, off_g + g * 15 + j) for j in range(15)]
            gx, gy, gz, nx, ny, nz, eyx, eyy, eyz, ezx, ezy, ezz, s, act, code = q
            ndotd = nx * dwx + ny * dwy + nz * dwz
            ndot0 = nx * (gx - px) + ny * (gy - py) + nz * (gz - pz)
            safe = torch.where(torch.abs(ndotd) > 1e-20, ndotd, torch.full_like(ndotd, 1e-20))
            t = ndot0 / safe
            hx = px + t * dwx - gx
            hy = py + t * dwy - gy
            hz = pz + t * dwz - gz
            ly = eyx * hx + eyy * hy + eyz * hz
            lz = ezx * hx + ezy * hy + ezz * hz
            half = s * 0.5
            f = torch.float32
            m_rect = (torch.abs(torch.maximum(torch.abs(ly), torch.abs(lz)) - half) <= fw).to(f)
            rr = torch.sqrt(ly * ly + lz * lz)
            m_circ = (torch.abs(rr - half) <= fw).to(f)
            cz = lz + half
            ra = torch.sqrt(ly * ly + cz * cz)
            m_arc = ((torch.abs(ra - s) <= fw) & (cz >= -fw)).to(f)
            m_chord = ((torch.abs(cz) <= fw) & (torch.abs(ly) <= s + fw)).to(f)
            m_half = torch.maximum(m_arc, m_chord)
            sel_circ = (code == 1).to(f)  # one-hot shape dispatch, as the kernel
            sel_half = (code == 2).to(f)
            m_frame = sel_circ * m_circ + sel_half * m_half + (1.0 - sel_circ - sel_half) * m_rect
            ok = (t > 0) & (m_frame > 0.5) & (torch.abs(ndotd) > 1e-20) & (act > 0.5)
            t_min = torch.minimum(t_min, torch.where(ok, t, big))
    return t_min


def depth_levels(t_min: torch.Tensor, max_depth: float) -> torch.Tensor:
    """The uint8 depth levels ``floor(255 (1 - t / max_depth))``, clipped to
    [0, 255], as float32 (components.py:626-628; empty -> 0)."""
    md = _f32(max_depth)
    t = torch.clamp_max(t_min, md)
    lev = torch.floor(255.0 * (1.0 - t / divisor(md, t)))
    return torch.clamp(lev, 0.0, 255.0)


def encode_levels(t_min: torch.Tensor, max_depth: float) -> torch.Tensor:
    """float32 in [0, 1] equal to the uint8 depth encoding / 255
    (``pallas_vision._encode_levels``, with its clip)."""
    return depth_levels(t_min, max_depth) * _f32(1.0 / 255.0)


def render_depth_reference(cfg: RenderConfig, dcam, cam, wcol) -> torch.Tensor:
    """Plain version of K5: levels (N, H*W)."""
    return encode_levels(render_tiles(cfg, dcam, cam, wcol), cfg.max_depth)


def launch_render_depth(cfg: RenderConfig, dcam, cam, wcol) -> torch.Tensor:
    """K5 on the card: levels (N, H*W)."""
    device = cam.device
    if device.type != "cuda":
        raise ValueError(f"render_depth launches on a CUDA device, got {device}")
    check_cuda_inputs(device, dcam=dcam, cam=cam, world_cols=wcol)
    n, hw = cam.shape[0], dcam.shape[1]
    if cam.shape != (n, CAM_COLS) or dcam.shape != (3, hw) or n < 1:
        raise ValueError("cam / dcam must be (N, 16) / (3, H*W)")
    if wcol.shape[1] != cfg.n_cols or wcol.shape[0] not in (1, n):
        raise ValueError(f"world columns must be (1 or N, {cfg.n_cols})")
    lib = _build.library()
    consts = cfg.as_array()
    out = torch.empty(n, hw, dtype=torch.float32, device=device)
    wstride = 0 if wcol.shape[0] == 1 else cfg.n_cols
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fpyv_render_depth(consts.ctypes.data, consts.size, dcam.data_ptr(), hw,
                                    cam.data_ptr(), wcol.data_ptr(), cfg.n_cols, wstride,
                                    out.data_ptr(), n, stream)
    _build.check(err, "render_depth")
    _build.launch_counts["render_depth"] += 1
    return out


def render_depth_matrix(cfg: RenderConfig, dcam, cam, wcol) -> torch.Tensor:
    """K5 on CUDA tensors, its plain version on CPU tensors."""
    if cam.device.type == "cpu":
        return render_depth_reference(cfg, dcam, cam, wcol)
    return launch_render_depth(cfg, dcam, cam, wcol)


def fused_render_depth(
    rig: CameraRig,
    cam_pos: torch.Tensor,  # (N, 3) or (3,)
    cam_R: torch.Tensor,  # (N, 3, 3) or (3, 3)
    world: World,  # shared or per-env batched
    max_depth: float = 10.0,
    include: Tuple[str, ...] = ("spheres", "cylinders", "ground", "gates"),
    ground_extent: Optional[float] = None,
    frame_width: float = 0.08,
) -> torch.Tensor:
    """float32 depth frames (N, H, W) in [0, 1], quantised to uint8 levels:
    ``render_depth_raycast(...) / 255``, in one kernel launch on CUDA."""
    cfg, dcam, cam, wcol = render_inputs(rig, cam_pos, cam_R, world, max_depth, include,
                                         ground_extent, frame_width)
    return render_depth_matrix(cfg, dcam, cam, wcol).reshape(frame_shape(rig, cam_pos))


def render_inputs(rig: CameraRig, cam_pos: torch.Tensor, cam_R: torch.Tensor, world: World,
                  max_depth: float, include: Tuple[str, ...], ground_extent: Optional[float],
                  frame_width: float):
    """(config, dcam, camera rows, world columns) of K5 for cameras (..., 3)
    and (..., 3, 3) on a shared or per-env batched world."""
    cam = camera_matrix(cam_pos.reshape(-1, 3), cam_R.reshape(-1, 3, 3))
    cfg = RenderConfig.for_world(world, max_depth, include, ground_extent, frame_width)
    dcam = device_dcam(rig, cam.device)
    return cfg, dcam, cam, world_cols(world)


def frame_shape(rig: CameraRig, cam_pos: torch.Tensor) -> Tuple[int, ...]:
    """(..., H, W) for cameras (..., 3)."""
    W, H = rig.resolution
    return tuple(cam_pos.shape[:-1]) + (H, W)


# ---------------------------------------------------------------------------
# K6: the chase pilot
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChasePilot:
    """The in-kernel FPV guidance pilot: the reference's
    ``calculate_needed_force_orientation`` autopilot (components.py:258-304,
    :func:`fpyv_tpu_torch.control.guidance.needed_force_orientation`) driven
    by the rendered target's centroid pixel, with a hover-scan while the
    target is out of frame. Fields mirror ``GuidanceParams`` and
    params.yaml's point_and_shoot block; the PID output clamps are the
    thrust-curve force limits."""

    virtual_drag_coef: float = 0.5
    virtual_lift_coef: float = 0.1
    tof_effective_distance: float = 2.0
    keep_distance: float = 6.0
    uwb_max_range: float = 13.0
    kP: float = 0.1
    kI: float = 2.0
    kD: float = 0.05
    integral_clip: float = 100.0
    derivative_transition_rate: float = 0.2
    integral_leak: float = 0.99
    # hover-scan while the target is out of frame: hover thrust tilted by
    # scan_tilt, its azimuth turning at scan_rate_dps (pans the camera)
    scan_tilt: float = 0.15
    scan_rate_dps: float = 45.0


@dataclass(frozen=True)
class ChaseConstants:
    """float32-rounded pilot constants in the order of ``ChaseConsts`` in
    ``csrc/vision_kernels.cu``."""

    mount: Tuple[float, ...]  # 9, row major
    rel: Tuple[float, float, float]
    k00: float
    k02: float
    k11: float
    k12: float
    gz: float
    scan_s: float
    scan_w: float
    drag: float
    lift: float
    tof: float
    keep: float
    uwb: float
    kP: float
    kI: float
    kD: float
    iclip: float
    rate: float
    rate_keep: float
    leak: float
    dt: float
    min_force: float
    max_force: float
    # the rig's K (pixel = K ray), for the target's pixel box: K00, K01, K02, K11, K12
    ku: float
    ks: float
    kcu: float
    kv: float
    kcv: float

    def as_array(self) -> np.ndarray:
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vals.extend(v if isinstance(v, tuple) else [v])
        return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=32)
def chase_constants(rig: CameraRig, pilot: ChasePilot, params: DroneParams) -> ChaseConstants:
    """The pilot's Python-float constants, each rounded once to float32 as
    ``pallas_vision._make_chase_action_fn`` rounds them. ``gz`` takes the
    nominal mass and g = 9.81 (components.py:270), not DomainRand's mass."""
    mass, dt = float(params.mass), float(params.dt)
    Ki, K = np.asarray(rig.K_inv), np.asarray(rig.K)
    rate = np.float32(pilot.derivative_transition_rate)
    curve = params.thrust_curve
    return ChaseConstants(
        mount=tuple(_f32(x) for x in np.asarray(rig.mount_rotation).reshape(-1)),
        rel=tuple(_f32(x) for x in rig.rel_position),
        k00=_f32(Ki[0, 0]), k02=_f32(Ki[0, 2]), k11=_f32(Ki[1, 1]), k12=_f32(Ki[1, 2]),
        gz=_f32(-9.81 * mass), scan_s=_f32(pilot.scan_tilt * 9.81 * mass),
        scan_w=_f32(np.deg2rad(pilot.scan_rate_dps) * dt),
        drag=_f32(pilot.virtual_drag_coef), lift=_f32(pilot.virtual_lift_coef),
        tof=_f32(pilot.tof_effective_distance), keep=_f32(pilot.keep_distance),
        uwb=_f32(pilot.uwb_max_range), kP=_f32(pilot.kP), kI=_f32(pilot.kI), kD=_f32(pilot.kD),
        iclip=_f32(pilot.integral_clip), rate=float(rate),
        rate_keep=float(np.float32(1.0) - rate), leak=_f32(pilot.integral_leak), dt=_f32(dt),
        min_force=_f32(curve.min_force), max_force=_f32(curve.max_force),
        ku=_f32(K[0, 0]), ks=_f32(K[0, 1]), kcu=_f32(K[0, 2]), kv=_f32(K[1, 1]), kcv=_f32(K[1, 2]),
    )


def quat_cols_from_R(m):
    """Shepperd's method over 9 row-major entry tensors -> (w, x, y, z),
    as ``pallas_vision._quat_cols_from_R``: same candidates, the same
    dominant-diagonal selection through where-chains, w >= 0."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m
    tr = m00 + m11 + m22

    def ssqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    sw = ssqrt(1.0 + tr)
    iw = 0.5 / sw
    cw = (0.5 * sw, (m21 - m12) * iw, (m02 - m20) * iw, (m10 - m01) * iw)
    sx = ssqrt(1.0 + m00 - m11 - m22)
    ix = 0.5 / sx
    cx = ((m21 - m12) * ix, 0.5 * sx, (m01 + m10) * ix, (m02 + m20) * ix)
    sy = ssqrt(1.0 - m00 + m11 - m22)
    iy = 0.5 / sy
    cy = ((m02 - m20) * iy, (m01 + m10) * iy, 0.5 * sy, (m12 + m21) * iy)
    sz = ssqrt(1.0 - m00 - m11 + m22)
    iz = 0.5 / sz
    cz = ((m10 - m01) * iz, (m02 + m20) * iz, (m12 + m21) * iz, 0.5 * sz)
    sel_w = (tr >= m00) & (tr >= m11) & (tr >= m22)
    sel_x = (m00 >= m11) & (m00 >= m22)
    sel_y = m11 >= m22
    q = [torch.where(sel_w, w_, torch.where(sel_x, x_, torch.where(sel_y, y_, z_)))
         for w_, x_, y_, z_ in zip(cw, cx, cy, cz)]
    sign = torch.where(q[0] < 0, -1.0, 1.0).to(q[0].dtype)
    return tuple(qi * sign for qi in q)


def camera_rows(mount, rel, st):
    """Camera pose from the state rows (position st[0:3], quaternion
    st[6:10]) with float32 ``mount`` (9, row major) and ``rel`` (3) as
    ``csrc/render.cuh::camera_pose``: cam_R = R mount (9 rows, R the body
    rotation) and the camera position (cx, cy, cz)."""
    px, py, pz, qw, qx, qy, qz = st[0], st[1], st[2], st[6], st[7], st[8], st[9]
    m, rp = mount, rel
    B = [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
         2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
         2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)]
    cR = [B[3 * r] * m[c] + B[3 * r + 1] * m[3 + c] + B[3 * r + 2] * m[6 + c]
          for r in range(3) for c in range(3)]
    cx = px + B[0] * rp[0] + B[1] * rp[1] + B[2] * rp[2]
    cy = py + B[3] * rp[0] + B[4] * rp[1] + B[5] * rp[2]
    cz = pz + B[6] * rp[0] + B[7] * rp[1] + B[8] * rp[2]
    return cR, (cx, cy, cz)


BOX_Z_EPS = 0.05  # m: a target reaching this near the camera plane renders the full frame
BOX_PAD = 2  # pixels added on each side of the projected box
CONE_MARGIN = 1.05  # on the frame's cone, against float32 rounding


def frame_cone(p: ChaseConstants, width: int, height: int) -> torch.Tensor:
    """tan of the half-angle of a cone about the optical axis that holds
    every pixel ray of the frame [0, W] x [0, H], in float32 as
    ``csrc/render.cuh::frame_cone``."""
    f = functools.partial(torch.tensor, dtype=torch.float32)
    ym = torch.maximum(f(p.kcv), f(float(height)) - p.kcv) / p.kv
    xm = (torch.maximum(f(p.kcu), f(float(width)) - p.kcu) + abs(p.ks) * ym) / p.ku
    return torch.sqrt(xm * xm + ym * ym)


def target_pixel_box(p: ChaseConstants, cam_R, cam_pos, target, radius, width: int,
                     height: int):
    """The pixel rectangle that holds every pixel of K6's target-only
    render that the target sphere can light, as ``csrc/render.cuh::
    target_pixel_box`` computes it operation for operation in float32.
    ``cam_R`` the 9 row-major camera rotation entries, ``cam_pos`` and
    ``target`` 3 tensors each, ``radius`` one; all (N,) float32.

    The centre in the camera frame is c = cam_Rᵀ (target − cam_pos). Where
    c.z + r < −:data:`BOX_Z_EPS` the sphere lies wholly behind the camera,
    every hit has t < 0, and the box is empty. Elsewhere, where c.z − r ≤
    :data:`BOX_Z_EPS` (across the camera plane, the camera inside the
    sphere, or NaN), the box is the full frame, unless the sphere stays
    outside the cone of the frame's rays (:func:`frame_cone`): its points
    with z > 0 lie at least ρ − r = |(c.x, c.y)| − r off the optical axis
    and at z ≤ c.z + r, so ρ > r + :data:`CONE_MARGIN` cone (c.z + r +
    :data:`BOX_Z_EPS`) lights no pixel and the box is empty. Otherwise the
    sphere lies in front of the camera and its rays (X, Y, 1) fill the
    tangent cone, X in (c.x c.z ± r √(c.x² + c.z² − r²)) / (c.z² − r²) and
    Y likewise; through K (u = K00 X + K01 Y + K02, v = K11 Y + K12; the skew
    over the Y range) and with the pixel centres at index + 0.5 that gives
    the index range, padded by :data:`BOX_PAD` against float32 rounding and
    clipped to the frame. Returns (u0, u1, v0, v1, full): int64 inclusive
    bounds, empty where u0 > u1 or v0 > v1, and the fallback flag."""
    ex, ey, ez = target[0] - cam_pos[0], target[1] - cam_pos[1], target[2] - cam_pos[2]
    R = cam_R
    cx = R[0] * ex + R[3] * ey + R[6] * ez
    cy = R[1] * ex + R[4] * ey + R[7] * ez
    cz = R[2] * ex + R[5] * ey + R[8] * ez
    r = radius
    zm = cz - r
    across = ~(zm > BOX_Z_EPS) & ~(cz + r < -BOX_Z_EPS)
    reach = r + CONE_MARGIN * frame_cone(p, width, height) * (cz + r + BOX_Z_EPS)
    behind = (cz + r < -BOX_Z_EPS) | (across & (cx * cx + cy * cy > reach * reach))
    full = across & ~behind
    # the full frame's and the empty boxes' lanes compute on a stand-in (den = 1), replaced
    # below
    den = torch.where(full | behind, torch.ones_like(zm), zm * (cz + r))
    inv = 1.0 / den
    qx = torch.sqrt(cx * cx + den)
    qy = torch.sqrt(cy * cy + den)
    xlo, xhi = (cx * cz - r * qx) * inv, (cx * cz + r * qx) * inv
    ylo, yhi = (cy * cz - r * qy) * inv, (cy * cz + r * qy) * inv
    slo = torch.minimum(p.ks * ylo, p.ks * yhi)
    shi = torch.maximum(p.ks * ylo, p.ks * yhi)

    def index(x, edge, lo):  # clipped in float32 before the integer conversion
        x = torch.floor(x - 0.5) - BOX_PAD if lo else torch.ceil(x - 0.5) + BOX_PAD
        return torch.clamp(x, -1.0, float(edge)).to(torch.int64)

    u0 = torch.clamp_min(index(p.ku * xlo + slo + p.kcu, width, True), 0)
    u1 = torch.clamp_max(index(p.ku * xhi + shi + p.kcu, width, False), width - 1)
    v0 = torch.clamp_min(index(p.kv * ylo + p.kcv, height, True), 0)
    v1 = torch.clamp_max(index(p.kv * yhi + p.kcv, height, False), height - 1)
    u0, v0 = torch.where(full | behind, 0, u0), torch.where(full | behind, 0, v0)
    u1 = torch.where(full, width - 1, torch.where(behind, -1, u1))
    v1 = torch.where(full, height - 1, torch.where(behind, -1, v1))
    return u0, u1, v0, v1, full


def chase_action_fn(p: ChaseConstants, dcam: torch.Tensor, width: int):
    """The per-step pilot for :func:`env_rollout_reference`'s ``action_fn``,
    line by line as ``pallas_vision._make_chase_action_fn``: camera pose,
    target-only render, mask centroid, guidance law and hover-scan, 'level'
    force basis. Returns (zero actions, override (qw, qx, qy, qz, |F|), the
    four PID memory rows)."""
    hw = dcam.shape[1]
    idx = torch.arange(hw, dtype=torch.float32, device=dcam.device)[None, :]
    wf = float(width)
    u_row = idx - torch.floor(idx / divisor(wf, idx)) * wf + 0.5
    v_row = torch.floor(idx / divisor(wf, idx)) + 0.5
    dt = divisor(p.dt, idx)
    dxr, dyr, dzr = dcam[0:1], dcam[1:2], dcam[2:3]
    m, rp, gz = p.mount, p.rel, p.gz

    def action_fn(i, st, centers, sphere_r):
        px, py, pz, vx, vy, vz = st[:6]
        cR, (cx, cy, cz) = camera_rows(m, rp, st)
        tx, ty, tz, tr = centers[0][0], centers[1][0], centers[2][0], sphere_r[0]

        # target-only render (sphere 0, active) and the mask centroid
        col = [x[:, None] for x in cR]
        dwx = col[0] * dxr + col[1] * dyr + col[2] * dzr
        dwy = col[3] * dxr + col[4] * dyr + col[5] * dzr
        dwz = col[6] * dxr + col[7] * dyr + col[8] * dzr
        a = dwx * dwx + dwy * dwy + dwz * dwz
        big = torch.tensor(_BIG, dtype=torch.float32, device=dcam.device)
        t = _sphere_t(a, cx[:, None] - tx, cy[:, None] - ty, cz[:, None] - tz, tr, True,
                      dwx, dwy, dwz, big)
        mask = (t < 1e30).to(torch.float32)
        cnt = mask.sum(1)
        safe = torch.clamp_min(cnt, 1.0)
        ucen = (mask * u_row).sum(1) / safe
        vcen = (mask * v_row).sum(1) / safe
        visible = cnt > 0.5
        theta = torch.tensor(np.float32(p.scan_w) * np.float32(i), device=dcam.device)
        scan_fx = p.scan_s * torch.cos(theta)
        scan_fy = p.scan_s * torch.sin(theta)

        # needed_force_orientation (components.py:258-304)
        dcx = p.k00 * ucen + p.k02
        dcy = p.k11 * vcen + p.k12
        dwx = cR[0] * dcx + cR[1] * dcy + cR[2]
        dwy = cR[3] * dcx + cR[4] * dcy + cR[5]
        dwz = cR[6] * dcx + cR[7] * dcy + cR[8]
        dn = torch.clamp_min(torch.sqrt(dwx * dwx + dwy * dwy + dwz * dwz), 1e-12)
        dwx, dwy, dwz = dwx / dn, dwy / dn, dwz / dn
        ddx, ddy, ddz = px - tx, py - ty, pz - tz
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz) - tr
        measured = torch.clamp_max(dist, p.uwb)  # UWB clamp (components.py:287)
        p_i, p_d, p_e, p_s = st[ENV_ROWS:ENV_ROWS + N_PILOT_ROWS]
        err = measured - p.keep
        integ = torch.clamp(p.leak * p_i + err * p.dt, -p.iclip, p.iclip)
        raw_d = torch.clamp(torch.where(p_s > 0.5, (err - p_e) / dt, 0.0), -1.0, 1.0)
        deriv = p.rate_keep * p_d + p.rate * raw_d
        mult = torch.clamp(p.kP * err + p.kI * integ + p.kD * deriv, p.min_force, p.max_force)
        vnorm = torch.sqrt(vx * vx + vy * vy + vz * vz)  # virtual drag (:271-285)
        inv_v = 1.0 / torch.clamp_min(vnorm, 1e-12)
        cosang = (vx * dwx + vy * dwy + vz * dwz) * inv_v
        vc = p.drag * (-(cosang - 1.0) / 2.0) * vnorm
        vdx, vdy, vdz = -vc * vx, -vc * vy, -vc * vz
        below = (pz < p.tof).to(torch.float32)  # virtual ground-effect lift (:286)
        vlift = below * -(p.tof - pz) * p.lift * gz * (1.0 + torch.abs(vz))
        fx_ = torch.where(visible, mult * dwx + vdx, scan_fx)
        fy_ = torch.where(visible, mult * dwy + vdy, scan_fy)
        fz_ = torch.where(visible, mult * dwz + vdz + vlift - gz, -gz)
        # the PID memory freezes while the target is out of frame
        pilot = [torch.where(visible, integ, p_i), torch.where(visible, deriv, p_d),
                 torch.where(visible, err, p_e), torch.where(visible, 1.0, p_s)]
        # 'level' force basis (components.py:294-303)
        yx = fy_ * gz
        yy = -fx_ * gz
        xx = yy * fz_
        xy = -yx * fz_
        xz = yx * fy_ - yy * fx_
        xn = torch.clamp_min(torch.sqrt(xx * xx + xy * xy + xz * xz), 1e-12)
        yn = torch.clamp_min(torch.sqrt(yx * yx + yy * yy), 1e-12)
        fn = torch.clamp_min(torch.sqrt(fx_ * fx_ + fy_ * fy_ + fz_ * fz_), 1e-12)
        Rd = (xx / xn, yx / yn, fx_ / fn, xy / xn, yy / yn, fy_ / fn, xz / xn, 0.0 * xz,
              fz_ / fn)
        fnorm = torch.sqrt(fx_ * fx_ + fy_ * fy_ + fz_ * fz_)
        zeros = torch.zeros_like(px)
        return [zeros] * 4, quat_cols_from_R(Rd) + (fnorm,), pilot

    return action_fn


# ---------------------------------------------------------------------------
# K6: plain version, launch, public wrapper
# ---------------------------------------------------------------------------


def vision_env_rollout_reference(env: AcroEnv, state_mat: torch.Tensor, world_mat: torch.Tensor,
                                 n_steps: int, rig: CameraRig, pilot: ChasePilot = ChasePilot(),
                                 seed: int = 0, cyl_mat: Optional[torch.Tensor] = None):
    """Plain version of K6 on the (28, N) chase state. Returns (state,
    reward sum (N,), number of resets, crash counts (N,), contact counts (N,))."""
    dcam = device_dcam(rig, state_mat.device)
    action_fn = chase_action_fn(chase_constants(rig, pilot, env.params), dcam, rig.resolution[0])
    return env_rollout_reference(env, state_mat, None, world_mat, n_steps, seed, cyl_mat,
                                 action_fn=action_fn, n_pilot_rows=N_PILOT_ROWS,
                                 extra_metrics=True)


def launch_vision_env_rollout(env: AcroEnv, state_mat, world_mat, n_steps: int, rig: CameraRig,
                              pilot: ChasePilot = ChasePilot(), seed: int = 0, cyl_mat=None,
                              probe: Optional[torch.Tensor] = None):
    """K6 on the card. Returns (state (28, N), reward sum, crash counts,
    contact counts), each (N,). ``probe`` (a zeroed int64 tensor of
    :data:`N_CHASE_PROBE` on the card; env without DomainRand or wind)
    launches the instrumented instantiation, which adds its phase clocks and
    pixel counts there (:func:`chase_probe_split`)."""
    device = state_mat.device
    if device.type != "cuda":
        raise ValueError(f"vision_env_rollout launches on a CUDA device, got {device}")
    check_cuda_inputs(device, state=state_mat, world=world_mat, cylinders=cyl_mat)
    if probe is not None and (probe.device != device or probe.dtype != torch.int64
                              or probe.shape != (N_CHASE_PROBE,)):
        raise ValueError(f"probe must be an int64 ({N_CHASE_PROBE},) tensor on {device}")
    if probe is not None and env.params.n_motors != 4:
        raise ValueError("the instrumented K6 is the quad's (n_motors=4)")
    n = state_mat.shape[1]
    if state_mat.shape != (CH_ROWS, n) or n < 1:
        raise ValueError(f"state must be ({CH_ROWS}, N)")
    if world_mat.ndim != 2 or world_mat.shape[0] != WORLD_ROWS:
        raise ValueError("world matrix must be (12, S)")
    if cyl_mat is not None and (cyl_mat.ndim != 2 or cyl_mat.shape[0] != 6):
        raise ValueError("cylinder matrix must be (6, C)")
    if not 1 <= n_steps <= MAX_STEPS_PER_LAUNCH:
        raise ValueError(f"n_steps must be in [1, {MAX_STEPS_PER_LAUNCH}]")
    lib = _build.library()
    kc = step_constants_array(env.params)
    c = env_constants(env)
    ec = env_constants_array(env)
    pc = chase_constants(rig, pilot, env.params).as_array()
    dcam = device_dcam(rig, device)
    W = rig.resolution[0]
    out = torch.empty_like(state_mat)
    rsum, crashes, contacts = (torch.empty(n, dtype=torch.float32, device=device)
                               for _ in range(3))
    S = world_mat.shape[1]
    C = 0 if cyl_mat is None else cyl_mat.shape[1]
    cyl_ptr = None if cyl_mat is None else cyl_mat.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fpyv_vision_env_rollout(
            kc.ctypes.data, kc.size, ec.ctypes.data, ec.size, pc.ctypes.data, pc.size,
            int(np.int64(seed).astype(np.int32)), state_mat.data_ptr(), world_mat.data_ptr(), S,
            cyl_ptr, C, dcam.data_ptr(), dcam.shape[1], W, out.data_ptr(), rsum.data_ptr(),
            crashes.data_ptr(), contacts.data_ptr(), n, n_steps, int(c.randomize),
            int(c.use_wind), None if probe is None else probe.data_ptr(), stream)
    _build.check(err, "vision_env_rollout")
    _build.launch_counts["vision_env_rollout"] += 1
    return out, rsum, crashes, contacts


CHASE_PHASES = ("pose", "render", "pilot", "step")  # ChasePhase in csrc/vision_kernels.cu
# the phases, pixels tested, full-frame and empty steps, pixels lit
N_CHASE_PROBE = len(CHASE_PHASES) + 4


def chase_probe_split(probe: torch.Tensor, n_envs: int, n_steps: int) -> dict:
    """An instrumented K6 launch's probe: each phase in ms a launch (each
    block's nanoseconds averaged over the n_envs blocks), the pixels tested
    per env-step, the env-steps that rendered the full frame and that
    tested no pixel (the target behind the camera or out of view), and the
    pixels lit per env-step (the target's mask: what any render must test)."""
    vals = probe.tolist()
    split = {name: float(v) / n_envs * 1e-6 for name, v in zip(CHASE_PHASES, vals)}
    split["pixels_per_step"] = vals[len(CHASE_PHASES)] / (n_envs * n_steps)
    split["full_frame_steps"] = vals[len(CHASE_PHASES) + 1]
    split["empty_steps"] = vals[len(CHASE_PHASES) + 2]
    split["lit_per_step"] = vals[len(CHASE_PHASES) + 3] / (n_envs * n_steps)
    return split


def vision_env_rollout_matrix(env: AcroEnv, state_mat, world_mat, n_steps: int, rig: CameraRig,
                              pilot: ChasePilot = ChasePilot(), seed: int = 0, cyl_mat=None):
    """K6 on CUDA tensors, its plain version on CPU tensors; returns (state,
    reward sum, crash counts, contact counts)."""
    if state_mat.device.type == "cpu":
        out, rsum, _, crashes, contacts = vision_env_rollout_reference(
            env, state_mat, world_mat, n_steps, rig, pilot, seed, cyl_mat)
        return out, rsum, crashes, contacts
    return launch_vision_env_rollout(env, state_mat, world_mat, n_steps, rig, pilot, seed,
                                     cyl_mat)


def chase_state_matrix(state: AcroState) -> torch.Tensor:
    """(28, N): K4's env rows and fresh (zero) PID memory, as ``pid_init``."""
    mat = env_state_to_matrix(state)
    return torch.cat([mat, torch.zeros(N_PILOT_ROWS, mat.shape[1], dtype=mat.dtype,
                                       device=mat.device)]).contiguous()


def fused_vision_env_rollout(
    env: AcroEnv,
    state: AcroState,
    world: World,
    n_steps: int,
    rig: Optional[CameraRig] = None,
    pilot: ChasePilot = ChasePilot(),
    seed: int = 0,
) -> Tuple[AcroState, World, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K steps of the FPV chase loop in one launch (the reference's dim==2
    loop, simulator.py:115-168). Returns (state, world with the target
    counters advanced, per-env reward sums, crash counts, target-contact
    counts). The PID memory starts at zero at every call, and the
    hover-scan angle counts from 0, as in the Pallas kernel."""
    if rig is None:
        rig = default_vision_rig()
    if not env_supported(env, world):
        raise ValueError("the chase loop needs att_mode='quat', float32 and ground")
    cyl_mat = cylinder_matrix(world) if world_has_cylinders(world) else None
    out, rsum, crashes, contacts = vision_env_rollout_matrix(
        env, chase_state_matrix(state), env_world_matrix(world), n_steps, rig, pilot, seed,
        cyl_mat)
    new_world = world.replace(
        sphere_path_count=world.sphere_path_count
        + n_steps * world.sphere_has_path.to(torch.int32))
    return (matrix_to_env_state(out[:ENV_ROWS], state), new_world, rsum, crashes, contacts)
