"""Fused drone physics step: CUDA kernels K2 (one step) and K3 (K steps)
with their plain PyTorch versions (mirrors ``fpyv_tpu.ops.pallas_step``).

The state is an SoA ``(15, N)`` float32 matrix, one row per component and
one column per env — the Pallas layout without its (8, N/8) sublane tiling:

  0:3 position   3:6 velocity   6:10 quaternion (w,x,y,z)
  10:13 rates (deg/s)   13 thrust (N)   14 done (0/1)

Worlds enter as a ``(5, S)`` sphere matrix (center xyz, radius, active) and,
when any cylinder is active, a ``(6, C)`` cylinder matrix (center xyz,
radius, height, active).

The physics core (K1, ``_step_components`` in the JAX package) is written
twice: as the ``__device__`` function ``step_components`` in
``csrc/physics.cuh`` and as :func:`step_components` here, in the same
operation order. Python-float constants are folded on the host in float64
in the JAX expression order and rounded once to float32
(:func:`step_constants`), exactly as JAX folds them before they meet a
float32 array.

:func:`fused_drone_step` and :func:`fused_rollout` take and return the
port's ``DroneState``. A state on the CPU runs the plain version; a state on
a CUDA device launches the kernel, and anything the kernel does not take
raises.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.physics.drone import AIR_DENSITY, DroneParams, DroneState, motor_layout
from fpyv_tpu_torch.physics.world import World

STATE_ROWS = 15
SPRING_K = 100.0
# The kernels' motor arrays hold this many points (kMaxMotors in
# csrc/physics.cuh); DroneParams.n_motors above it is refused.
MAX_MOTORS = 16
ONE_THREAD_ENVS = 32768  # kOneThreadEnvs in csrc/lanes.cuh
_DEG2RAD = math.pi / 180.0
_log = logging.getLogger(__name__)


def _f32(x: float) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def state_to_matrix(state: DroneState) -> torch.Tensor:
    """DroneState (batched, quat mode) -> (15, N) float32 matrix."""
    rows = [state.pos[:, 0], state.pos[:, 1], state.pos[:, 2],
            state.vel[:, 0], state.vel[:, 1], state.vel[:, 2],
            state.att[:, 0], state.att[:, 1], state.att[:, 2], state.att[:, 3],
            state.rates[:, 0], state.rates[:, 1], state.rates[:, 2],
            state.thrust, state.done.to(torch.float32)]
    return torch.stack([r.to(torch.float32) for r in rows]).contiguous()


def matrix_to_state(mat: torch.Tensor, template: DroneState) -> DroneState:
    return DroneState(
        pos=mat[0:3].T.contiguous(),
        vel=mat[3:6].T.contiguous(),
        att=mat[6:10].T.contiguous(),
        rates=mat[10:13].T.contiguous(),
        thrust=mat[13].clone(),
        accel=template.accel,  # not tracked by the kernel (obs-only field)
        done=mat[14] > 0.5,
    )


def action_matrix(action: torch.Tensor) -> torch.Tensor:
    """(N, 4) -> (4, N) float32."""
    return action.to(torch.float32).T.contiguous()


def sphere_matrix(world: World) -> torch.Tensor:
    """(5, S) rows: center xyz, radius, active."""
    f = torch.float32
    return torch.cat([world.sphere_center.T.to(f), world.sphere_radius[None].to(f),
                      world.sphere_active[None].to(f)]).contiguous()


def cylinder_matrix(world: World) -> torch.Tensor:
    """(6, C) rows: center xyz, radius, height, active."""
    f = torch.float32
    return torch.cat([world.cyl_center.T.to(f), world.cyl_radius[None].to(f),
                      world.cyl_height[None].to(f), world.cyl_active[None].to(f)]).contiguous()


def world_has_cylinders(world: World) -> bool:
    """Host-side gate: sphere-only worlds skip the cylinder loop."""
    return bool(world.cyl_active.any())


def supported(params: DroneParams, world: World) -> bool:
    return params.att_mode == "quat" and bool(world.has_ground)


# ---------------------------------------------------------------------------
# Constants folded on the host
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepConstants:
    """float32-rounded physics constants, in the order of ``StepConsts`` in
    ``csrc/physics.cuh``. ``motor_x`` and ``motor_y`` hold the ``n_motors``
    motor points; :meth:`as_array` pads them with zeros to
    :data:`MAX_MOTORS`."""

    dt: float
    max_rates: float
    rate_a: float
    rate_keep: float
    thrust_b: float
    thrust_keep: float
    c3: float
    c2: float
    c1: float
    c0: float
    drag_x: float
    drag_y: float
    drag_z: float
    gz: float
    mass: float
    inv_m: float
    half_rate: float
    motor_radius: float
    neg_spring: float
    n_motors: int
    motor_x: Tuple[float, ...]
    motor_y: Tuple[float, ...]
    reps: int

    def as_array(self) -> np.ndarray:
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vals.extend(v + (0.0,) * (MAX_MOTORS - len(v)) if isinstance(v, tuple) else [v])
        return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=64)
def step_constants(params: DroneParams) -> StepConstants:
    """Fold each Python-float expression of ``_step_components`` in float64,
    in the JAX order, and round once to float32."""
    a, b = params.rates_transition_rate, params.thrust_transition_rate
    c3, c2, c1, c0 = params.thrust_curve.throttle2thrust_coeffs
    k = -0.5 * AIR_DENSITY
    (cdx, cdy, cdz), (ax_, ay_, az_) = params.drag_coef, params.cross_sections
    motors = motor_layout(params.n_motors)
    if len(motors) > MAX_MOTORS:
        raise ValueError(f"the fused kernels take at most {MAX_MOTORS} motors "
                         f"(MAX_MOTORS), got n_motors={params.n_motors}")
    return StepConstants(
        dt=_f32(params.dt), max_rates=_f32(params.max_rates),
        rate_a=_f32(a), rate_keep=_f32(1 - a),
        thrust_b=_f32(b), thrust_keep=_f32(1 - b),
        c3=_f32(c3), c2=_f32(c2), c1=_f32(c1), c0=_f32(c0),
        drag_x=_f32(k * cdx * ax_), drag_y=_f32(k * cdy * ay_), drag_z=_f32(k * cdz * az_),
        gz=_f32(-params.gravity * params.mass), mass=_f32(params.mass),
        inv_m=_f32(1.0 / params.mass), half_rate=_f32(0.5 * _DEG2RAD * params.dt),
        motor_radius=_f32(params.motor_radius), neg_spring=-SPRING_K,
        n_motors=len(motors), motor_x=tuple(_f32(float(m[0])) for m in motors),
        motor_y=tuple(_f32(float(m[1])) for m in motors),
        reps=2 if params.double_rotation_quirk else 1,
    )


@functools.lru_cache(maxsize=64)
def step_constants_array(params: DroneParams) -> np.ndarray:
    """:func:`step_constants` as the float32 array a launch passes (cached:
    every launch reads it)."""
    arr = step_constants(params).as_array()
    arr.setflags(write=False)
    return arr


# ---------------------------------------------------------------------------
# Plain PyTorch version (K1 and the bodies of K2/K3)
# ---------------------------------------------------------------------------


def _lt0(x: torch.Tensor) -> torch.Tensor:
    return (x < 0).to(x.dtype)


def step_components(k: StepConstants, spheres, comps: Sequence[torch.Tensor],
                    acts: Sequence[torch.Tensor], cyls=(), dr=None, wind=None,
                    override=None, with_accel_z: bool = False) -> List[torch.Tensor]:
    """One physics step over 15 state rows of shape (N,), line by line as
    ``fpyv_tpu.ops.pallas_step._step_components``. ``spheres`` is a list of
    (cx, cy, cz, r, active) and ``cyls`` of (cx, cy, cz, r, h, active),
    scalars or tensors broadcasting against the rows; ``dr`` is
    (mass, drag, thrust) scales, ``wind`` (wx, wy, wz), ``override``
    (qw, qx, qy, qz, |F|). Returns the 15 next-state rows, and with
    ``with_accel_z`` the world-z acceleration of the step as a 16th."""
    px, py, pz, vx, vy, vz, qw, qx, qy, qz, r0, r1, r2, thrust_prev, done = comps
    mr = k.max_rates
    rc0 = torch.clamp(-acts[0] * mr, -mr, mr)
    rc1 = torch.clamp(-acts[1] * mr, -mr, mr)
    rc2 = torch.clamp(-acts[2] * mr, -mr, mr)
    n0 = rc0 * k.rate_a + r0 * k.rate_keep
    n1 = rc1 * k.rate_a + r1 * k.rate_keep
    n2 = rc2 * k.rate_a + r2 * k.rate_keep
    xpct = 100.0 * (torch.clamp(acts[3], -1.0, 1.0) + 1.0) * 0.5
    poly = ((k.c3 * xpct + k.c2) * xpct + k.c1) * xpct + k.c0
    thrust = poly * k.thrust_b + thrust_prev * k.thrust_keep
    if dr is not None:
        thrust = thrust * dr[2]

    if override is not None:
        qw, qx, qy, qz, applied_thrust = override
    else:
        applied_thrust = thrust

    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - qz * qw)
    R02 = 2 * (qx * qz + qy * qw)
    R10 = 2 * (qx * qy + qz * qw)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - qx * qw)
    R20 = 2 * (qx * qz - qy * qw)
    R21 = 2 * (qy * qz + qx * qw)
    R22 = 1 - 2 * (qx * qx + qy * qy)

    tx, ty, tz = R02 * applied_thrust, R12 * applied_thrust, R22 * applied_thrust

    if wind is None:
        wx_, wy_, wz_ = vx, vy, vz
    else:
        wx_, wy_, wz_ = vx + wind[0], vy + wind[1], vz + wind[2]
    vnorm = torch.sqrt(wx_ * wx_ + wy_ * wy_ + wz_ * wz_)
    bx = R00 * wx_ + R10 * wy_ + R20 * wz_
    by = R01 * wx_ + R11 * wy_ + R21 * wz_
    bz = R02 * wx_ + R12 * wy_ + R22 * wz_
    fbx = k.drag_x * bx * vnorm
    fby = k.drag_y * by * vnorm
    fbz = k.drag_z * bz * vnorm
    dx = R00 * fbx + R01 * fby + R02 * fbz
    dy = R10 * fbx + R11 * fby + R12 * fbz
    dz = R20 * fbx + R21 * fby + R22 * fbz
    if dr is not None:
        dx, dy, dz = dx * dr[1], dy * dr[1], dz * dr[1]

    gz = k.gz
    if dr is not None:
        gz = gz * dr[0]

    rm = k.motor_radius
    cfx = torch.zeros_like(px)
    cfy = torch.zeros_like(px)
    cfz = torch.zeros_like(px)
    crashed = torch.zeros_like(px)
    for m0, m1 in zip(k.motor_x, k.motor_y):  # the n_motors points in order
        mx = px + R00 * m0 + R01 * m1
        my = py + R10 * m0 + R11 * m1
        mz = pz + R20 * m0 + R21 * m1
        pen = mz - rm
        hit = _lt0(pen)
        cfz = cfz + hit * (k.neg_spring * pen)
        crashed = torch.maximum(crashed, _lt0(mz))
        for (sx, sy, sz, sr_, act_s) in spheres:
            ddx, ddy, ddz = mx - sx, my - sy, mz - sz
            dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
            sd = dist - sr_
            inv = 1.0 / torch.clamp_min(dist, 1e-12)
            pen_s = sd - rm
            hit_s = _lt0(pen_s) * act_s
            mag = k.neg_spring * pen_s
            cfx = cfx + hit_s * mag * ddx * inv
            cfy = cfy + hit_s * mag * ddy * inv
            cfz = cfz + hit_s * mag * ddz * inv
            crashed = torch.maximum(crashed, _lt0(sd) * act_s)
        for (cx_, cy2, cz_, cr_, ch_, act_c) in cyls:
            ddx, ddy = mx - cx_, my - cy2
            r2d = torch.sqrt(ddx * ddx + ddy * ddy)
            d2d = r2d - cr_
            z0, z1 = cz_, cz_ + ch_
            in_band = ((z0 < mz) & (mz < z1)).to(px.dtype)
            dh = torch.minimum(torch.abs(mz - z0), torch.abs(mz - z1))
            d = in_band * d2d + (1 - in_band) * torch.sqrt(d2d * d2d + dh * dh)
            # normal: RELATIVE z against the ABSOLUTE band (components.py:719-720)
            relz = mz - cz_
            band_n = ((z0 < relz) & (relz < z1)).to(px.dtype)
            inv2d = 1.0 / torch.clamp_min(r2d, 1e-12)
            cap_sign = torch.where(torch.abs(relz - z0) < torch.abs(relz - z1), -1.0, 1.0
                                   ).to(px.dtype)
            nx_ = band_n * ddx * inv2d
            ny_ = band_n * ddy * inv2d
            nz_ = (1 - band_n) * cap_sign
            pen_c = d - rm
            hit_c = _lt0(pen_c) * act_c
            mag = k.neg_spring * pen_c
            cfx = cfx + hit_c * mag * nx_
            cfy = cfy + hit_c * mag * ny_
            cfz = cfz + hit_c * mag * nz_
            crashed = torch.maximum(crashed, _lt0(d) * act_c)

    inv_m = k.inv_m if dr is None else 1.0 / (k.mass * dr[0])
    acx = (tx + dx + cfx) * inv_m
    acy = (ty + dy + cfy) * inv_m
    acz = (tz + dz + gz + cfz) * inv_m

    dt = k.dt
    px, py, pz = px + vx * dt, py + vy * dt, pz + vz * dt
    vx, vy, vz = vx + acx * dt, vy + acy * dt, vz + acz * dt

    h0, h1, h2 = n0 * k.half_rate, n1 * k.half_rate, n2 * k.half_rate
    cr, sr = torch.cos(h0), torch.sin(h0)
    cp, sp = torch.cos(h1), torch.sin(h1)
    cy, sy = torch.cos(h2), torch.sin(h2)
    ew = cy * cp * cr + sy * sp * sr
    ex = cy * cp * sr - sy * sp * cr
    ey = cy * sp * cr + sy * cp * sr
    ez = sy * cp * cr - cy * sp * sr
    for _ in range(k.reps):
        nw = qw * ew + qx * ex + qy * ey + qz * ez
        nx = -qw * ex + qx * ew - qy * ez + qz * ey
        ny = -qw * ey + qx * ez + qy * ew - qz * ex
        nz = -qw * ez - qx * ey + qy * ex + qz * ew
        qw, qx, qy, qz = nw, nx, ny, nz
    qn = 1.0 / torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    qw, qx, qy, qz = qw * qn, qx * qn, qy * qn, qz * qn

    done = torch.maximum(done, crashed)
    out = [px, py, pz, vx, vy, vz, qw, qx, qy, qz, n0, n1, n2, thrust, done]
    return out + [acz] if with_accel_z else out


def sphere_list(centers: torch.Tensor, radius: torch.Tensor, active: torch.Tensor):
    """(3, S) centers + (S,) radius/active -> [(cx, cy, cz, r, active)]."""
    return list(zip(centers[0], centers[1], centers[2], radius, active))


def cylinder_list(cyl_mat: Optional[torch.Tensor]):
    return [] if cyl_mat is None else list(zip(*cyl_mat))


def drone_step_reference(params: DroneParams, state_mat: torch.Tensor,
                         action_mat: torch.Tensor, sphere_mat: torch.Tensor,
                         cyl_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K2: one step of the (15, N) state."""
    return rollout_reference(params, state_mat, action_mat, sphere_mat, 1, cyl_mat)


def rollout_reference(params: DroneParams, state_mat: torch.Tensor,
                      action_mat: torch.Tensor, sphere_mat: torch.Tensor, n_steps: int,
                      cyl_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of K3: ``n_steps`` steps with a constant action."""
    k = step_constants(params)
    spheres = sphere_list(sphere_mat[0:3], sphere_mat[3], sphere_mat[4])
    cyls = cylinder_list(cyl_mat)
    comps = list(state_mat.unbind(0))
    acts = list(action_mat.unbind(0))
    for _ in range(n_steps):
        comps = step_components(k, spheres, comps, acts, cyls=cyls)
    return torch.stack(comps)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


def check_cuda_inputs(device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on ``device``."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_step_shapes(state_mat, action_mat, sphere_mat, cyl_mat):
    n = state_mat.shape[1]
    if state_mat.shape != (STATE_ROWS, n) or action_mat.shape != (4, n):
        raise ValueError(f"state {tuple(state_mat.shape)} / action "
                         f"{tuple(action_mat.shape)} must be (15, N) / (4, N)")
    if sphere_mat.ndim != 2 or sphere_mat.shape[0] != 5:
        raise ValueError("sphere matrix must be (5, S)")
    if cyl_mat is not None and (cyl_mat.ndim != 2 or cyl_mat.shape[0] != 6):
        raise ValueError("cylinder matrix must be (6, C)")
    return n


def launch_drone_step(params, state_mat, action_mat, sphere_mat, cyl_mat=None):
    """K2 on the card: one step of the (15, N) state."""
    return _launch_step("drone_step", params, state_mat, action_mat, sphere_mat, cyl_mat, 1)


def launch_rollout(params, state_mat, action_mat, sphere_mat, n_steps, cyl_mat=None):
    """K3 on the card: ``n_steps`` steps, state held in registers."""
    return _launch_step("rollout", params, state_mat, action_mat, sphere_mat, cyl_mat,
                        n_steps)


def _launch_step(kernel, params, state_mat, action_mat, sphere_mat, cyl_mat, n_steps):
    device = state_mat.device
    if device.type != "cuda":
        raise ValueError(f"{kernel} launches on a CUDA device, got {device}")
    check_cuda_inputs(device, state=state_mat, action=action_mat, spheres=sphere_mat,
                      cylinders=cyl_mat)
    n = _check_step_shapes(state_mat, action_mat, sphere_mat, cyl_mat)
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    lib = _build.library()
    consts = step_constants_array(params)
    out = torch.empty_like(state_mat)
    S = sphere_mat.shape[1]
    C = 0 if cyl_mat is None else cyl_mat.shape[1]
    log_lanes(kernel, lib.fpyv_rollout_lanes(consts.ctypes.data, consts.size, S, C, n), n,
              params.n_motors, S, C)
    cyl_ptr = None if cyl_mat is None else cyl_mat.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if kernel == "drone_step":
            err = lib.fpyv_drone_step(consts.ctypes.data, consts.size, state_mat.data_ptr(),
                                      action_mat.data_ptr(), sphere_mat.data_ptr(), S,
                                      cyl_ptr, C, out.data_ptr(), n, stream)
        else:
            err = lib.fpyv_rollout(consts.ctypes.data, consts.size, state_mat.data_ptr(),
                                   action_mat.data_ptr(), sphere_mat.data_ptr(), S,
                                   cyl_ptr, C, out.data_ptr(), n, n_steps, stream)
    _build.check(err, kernel)
    _build.launch_counts[kernel] += 1
    return out


def log_lanes(kernel: str, lanes: int, n: int, n_motors: int, S: int, C: int) -> None:
    """Log K3's or K4's launch design when its staged contact terms do not
    fit a block below :data:`ONE_THREAD_ENVS` envs (it then runs one thread
    an env); ``lanes`` is what the library's ``*_lanes`` query returned."""
    if lanes < 0:
        raise ValueError(f"{kernel}: the kernel refuses these step constants")
    if lanes == 1 and n < ONE_THREAD_ENVS:
        _log_one_thread(kernel, n_motors, S, C)


@functools.lru_cache(maxsize=64)
def _log_one_thread(kernel: str, n_motors: int, S: int, C: int) -> None:
    _log.info("%s: %d motors x (1 + %d spheres + %d cylinders) staged terms do not fit a "
              "block's shared memory; one thread an env", kernel, n_motors, S, C)


def drone_step_matrix(params, state_mat, action_mat, sphere_mat, cyl_mat=None):
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if state_mat.device.type == "cpu":
        return drone_step_reference(params, state_mat, action_mat, sphere_mat, cyl_mat)
    return launch_drone_step(params, state_mat, action_mat, sphere_mat, cyl_mat)


def rollout_matrix(params, state_mat, action_mat, sphere_mat, n_steps, cyl_mat=None):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if state_mat.device.type == "cpu":
        return rollout_reference(params, state_mat, action_mat, sphere_mat, n_steps, cyl_mat)
    return launch_rollout(params, state_mat, action_mat, sphere_mat, n_steps, cyl_mat)


# ---------------------------------------------------------------------------
# Public wrappers (the JAX package's pallas_drone_step / pallas_rollout)
# ---------------------------------------------------------------------------


def _prepare(params, state, action, world):
    if not supported(params, world):
        raise ValueError("the fused step needs att_mode='quat' and a world with ground")
    cyl = cylinder_matrix(world) if world_has_cylinders(world) else None
    return state_to_matrix(state), action_matrix(action), sphere_matrix(world), cyl


def fused_drone_step(params: DroneParams, state: DroneState, action: torch.Tensor,
                     world: World) -> DroneState:
    """One fused physics step; ``action`` (N, 4)."""
    s, a, sph, cyl = _prepare(params, state, action, world)
    return matrix_to_state(drone_step_matrix(params, s, a, sph, cyl), state)


def fused_rollout(params: DroneParams, state: DroneState, action: torch.Tensor,
                  world: World, n_steps: int) -> DroneState:
    """``n_steps`` fused steps with a constant action."""
    s, a, sph, cyl = _prepare(params, state, action, world)
    return matrix_to_state(rollout_matrix(params, s, a, sph, n_steps, cyl), state)
