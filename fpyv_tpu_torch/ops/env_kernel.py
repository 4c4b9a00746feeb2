"""Full-env megaloop: CUDA kernel K4 with its plain PyTorch version
(mirrors ``fpyv_tpu.ops.pallas_env``).

One launch advances the env bank K steps of ``AcroEnv``: physics (K1),
CircularPath target motion, reward, the t / prev_dist / return rows, and
auto-reset on crash or truncation with uniform and Box-Muller draws,
DomainRand resampling and per-episode wind gusts.

State matrix ``(24, N)`` float32: rows 0..14 as in
:mod:`fpyv_tpu_torch.ops.step_kernel`, then 15 t, 16 prev_dist,
17 episode_return, 18 mass_scale, 19 drag_scale, 20 thrust_scale,
21:24 wind xyz. World matrix ``(12, S)``: 0:3 center xyz, 3 radius,
4 active, 5:8 path center, 8 path radius, 9 path resolution, 10 has_path,
11 path count.

RNG: the JAX kernel's counter-based murmur3-finalizer hash, bit for bit.
Env ``n`` has ``lane_id = fmix(n ^ fmix(uint32(seed)))`` (the Pallas
``_pack`` puts env n at sublane n // (N/8), lane n % (N/8), so its
pre-mix lane id is n); draw ``d`` of iteration ``i`` is
``fmix(lane_id ^ ((i+1)*32 + d) * 0x9E3779B9)``, its top 24 bits scaled by
2^-24. The draws depend only on (env, step, draw, seed), so the CUDA kernel
computes them on resetting lanes only and the results are the same. The
plain version computes the hash in int64 tensors masked to 32 bits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from fpyv_tpu_torch.envs.acro import AcroEnv, AcroState
from fpyv_tpu_torch.ops import _build
from fpyv_tpu_torch.ops.step_kernel import (
    ONE_THREAD_ENVS,
    STATE_ROWS,
    _f32,
    action_matrix,
    check_cuda_inputs,
    cylinder_list,
    cylinder_matrix,
    log_lanes,
    matrix_to_state,
    state_to_matrix,
    step_components,
    step_constants,
    step_constants_array,
    world_has_cylinders,
)
from fpyv_tpu_torch.physics.drone import DomainRand
from fpyv_tpu_torch.physics.world import World
from fpyv_tpu_torch.utils.profiling import span

ENV_EXTRA_ROWS = 9
ENV_ROWS = STATE_ROWS + ENV_EXTRA_ROWS
WORLD_ROWS = 12
MAX_STEPS_PER_LAUNCH = (1 << 24) - 1  # t and the target counter stay exact in float32

_TWO_PI = 2.0 * math.pi
_DEG2RAD = math.pi / 180.0
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based PRNG (murmur3 finalizer) on int64 tensors holding uint32 values
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def murmur3_fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_01(lane_id: torch.Tensor, ctr: int) -> torch.Tensor:
    """U[0, 1) with a 24-bit mantissa from (per-env lane id, counter)."""
    bits = murmur3_fmix(lane_id ^ ((ctr * 0x9E3779B9) & _MASK32))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def normal_pair(lane_id: torch.Tensor, ctr_a: int, ctr_b: int):
    """Box-Muller: two standard normals from two uniform draws."""
    u1 = torch.clamp_min(uniform_01(lane_id, ctr_a), _f32(1e-12))
    u2 = uniform_01(lane_id, ctr_b)
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = _f32(_TWO_PI) * u2
    return r * torch.cos(a), r * torch.sin(a)


def lane_ids(n: int, seed: int, device) -> torch.Tensor:
    """Per-env stream ids ``fmix(n ^ fmix(uint32(seed)))`` as int64."""
    s = murmur3_fmix(torch.tensor(seed & _MASK32, dtype=torch.int64, device=device))
    return murmur3_fmix(torch.arange(n, dtype=torch.int64, device=device) ^ s)


# ---------------------------------------------------------------------------
# Env constants folded on the host
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EnvConstants:
    """float32-rounded AcroEnv scalars in the order of ``EnvConsts`` in
    ``csrc/env_kernels.cu``; ``randomize``/``use_wind`` select the kernel."""

    pos_low: Tuple[float, float, float]
    pos_span: Tuple[float, float, float]
    vel_scale: float
    half_ypr: float
    max_steps: float
    w_progress: float
    w_alive: float
    w_crash: float
    w_rates: float
    mass_lo: float
    mass_span: float
    drag_lo: float
    drag_span: float
    thrust_lo: float
    thrust_span: float
    wind: Tuple[float, float, float]
    wind_scale: float
    gust: float  # 1.0 when wind gusts are drawn at reset
    randomize: bool
    use_wind: bool

    def as_array(self) -> np.ndarray:
        vals = []
        for f in dataclasses.fields(self):
            if f.name in ("randomize", "use_wind"):
                continue
            v = getattr(self, f.name)
            vals.extend(v if isinstance(v, tuple) else [v])
        return np.asarray(vals, np.float32)


@functools.lru_cache(maxsize=64)
def env_constants(env: AcroEnv) -> EnvConstants:
    use_wind = any(w != 0.0 for w in env.wind) or env.wind_scale > 0.0
    lo, hi = env.pos_low, env.pos_high
    mr, dr, tr = env.mass_range, env.drag_range, env.thrust_range
    return EnvConstants(
        pos_low=tuple(_f32(x) for x in lo),
        pos_span=tuple(_f32(h - l) for l, h in zip(lo, hi)),
        vel_scale=_f32(env.vel_scale),
        half_ypr=_f32(0.5 * _DEG2RAD * env.ypr_range_deg),
        max_steps=_f32(env.max_episode_steps),
        w_progress=_f32(env.w_progress), w_alive=_f32(env.w_alive),
        w_crash=_f32(env.w_crash), w_rates=_f32(env.w_rates),
        mass_lo=_f32(mr[0]), mass_span=_f32(mr[1] - mr[0]),
        drag_lo=_f32(dr[0]), drag_span=_f32(dr[1] - dr[0]),
        thrust_lo=_f32(tr[0]), thrust_span=_f32(tr[1] - tr[0]),
        wind=tuple(_f32(w) for w in env.wind), wind_scale=_f32(env.wind_scale),
        gust=1.0 if (use_wind and env.wind_scale > 0.0) else 0.0,
        randomize=bool(env.randomize), use_wind=use_wind,
    )


@functools.lru_cache(maxsize=64)
def env_constants_array(env: AcroEnv) -> np.ndarray:
    """:func:`env_constants` as the float32 array a launch passes (cached)."""
    arr = env_constants(env).as_array()
    arr.setflags(write=False)
    return arr


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------


def env_supported(env: AcroEnv, world: World) -> bool:
    return (env.params.att_mode == "quat" and env.dtype == torch.float32
            and bool(world.has_ground))


def env_state_to_matrix(state: AcroState) -> torch.Tensor:
    phys = state_to_matrix(state.drone)
    n = phys.shape[1]

    def row(x):  # nominal DR may be unbatched
        return torch.broadcast_to(x.to(torch.float32), (n,))

    dr, w = state.domain_rand, state.wind
    extras = torch.stack([
        row(state.t), row(state.prev_dist), row(state.episode_return),
        row(dr.mass_scale), row(dr.drag_scale), row(dr.thrust_scale),
        row(w[..., 0]), row(w[..., 1]), row(w[..., 2]),
    ])
    return torch.cat([phys, extras]).contiguous()


def matrix_to_env_state(mat: torch.Tensor, template: AcroState) -> AcroState:
    r = STATE_ROWS
    return AcroState(
        drone=matrix_to_state(mat[:r], template.drone),
        domain_rand=DomainRand(mass_scale=mat[r + 3].clone(), drag_scale=mat[r + 4].clone(),
                               thrust_scale=mat[r + 5].clone()),
        t=mat[r].to(torch.int32),
        prev_dist=mat[r + 1].clone(),
        episode_return=mat[r + 2].clone(),
        wind=mat[r + 6:r + 9].T.contiguous(),
    )


def env_world_matrix(world: World) -> torch.Tensor:
    """(12, S) world rows. The path count enters reduced modulo the path
    resolution: the same target position, and float32 stays exact for
    count + K below 2^24 however long the bank has run."""
    f = torch.float32
    res = torch.clamp_min(world.sphere_path_res.to(torch.int64), 1)
    count = torch.remainder(world.sphere_path_count.to(torch.int64), res)
    return torch.cat([
        world.sphere_center.T.to(f), world.sphere_radius[None].to(f),
        world.sphere_active[None].to(f), world.sphere_path_center.T.to(f),
        world.sphere_path_radius[None].to(f), world.sphere_path_res[None].to(f),
        world.sphere_has_path[None].to(f), count[None].to(f),
    ]).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version of K4
# ---------------------------------------------------------------------------


def reset_pose(c: EnvConstants, lane_id: torch.Tensor, i: int, tx, ty, tz):
    """The auto-reset pose of iteration ``i`` (``AcroEnv._sample_drone``
    distributions, draws 0..9): ([px, py, pz, vx, vy, vz, qw, qx, qy, qz],
    distance from the fresh position to (tx, ty, tz))."""
    base = (i + 1) * 32

    def u(d):
        return uniform_01(lane_id, base + d)

    rpx = c.pos_low[0] + u(0) * c.pos_span[0]
    rpy = c.pos_low[1] + u(1) * c.pos_span[1]
    rpz = c.pos_low[2] + u(2) * c.pos_span[2]
    z0, z1 = normal_pair(lane_id, base + 3, base + 4)
    z2, _ = normal_pair(lane_id, base + 5, base + 6)
    h0 = (2.0 * u(7) - 1.0) * c.half_ypr
    h1 = (2.0 * u(8) - 1.0) * c.half_ypr
    h2 = (2.0 * u(9) - 1.0) * c.half_ypr
    cr, sr = torch.cos(h0), torch.sin(h0)
    cp, sp = torch.cos(h1), torch.sin(h1)
    cy_, sy_ = torch.cos(h2), torch.sin(h2)
    rdx, rdy, rdz = rpx - tx, rpy - ty, rpz - tz
    return ([rpx, rpy, rpz, c.vel_scale * z0, c.vel_scale * z1, c.vel_scale * z2,
             cy_ * cp * cr + sy_ * sp * sr, cy_ * cp * sr - sy_ * sp * cr,
             cy_ * sp * cr + sy_ * cp * sr, sy_ * cp * cr - cy_ * sp * sr],
            torch.sqrt(rdx * rdx + rdy * rdy + rdz * rdz))


def env_rollout_reference(env: AcroEnv, state_mat: torch.Tensor,
                          action_mat: Optional[torch.Tensor], world_mat: torch.Tensor,
                          n_steps: int, seed: int = 0, cyl_mat: Optional[torch.Tensor] = None,
                          action_fn: Optional[Callable] = None, n_pilot_rows: int = 0,
                          extra_metrics: bool = False):
    """Plain version of K4, line by line as
    ``fpyv_tpu.ops.pallas_env._env_loop_math``. Returns (state, reward sum
    (N,), number of resets in the run), and with ``extra_metrics`` also the
    per-env crash and target-contact counts (N,): a contact is a crash
    within ``sphere_r[0] + 0.3`` of the chased target.

    ``action_fn(i, st, centers, sphere_r) -> (acts, override, pilot)``
    replaces the fixed ``action_mat`` (the chase pilot of K6): ``st`` is the
    list of state rows, ``centers`` the step's (cx, cy, cz) sphere rows,
    ``acts`` four action rows, ``override`` None or (qw, qx, qy, qz, |F|)
    for the physics, and ``pilot`` the ``n_pilot_rows`` updated memory rows
    that ride after the 24 env rows and are zeroed on reset."""
    k = step_constants(env.params)
    c = env_constants(env)
    n = state_mat.shape[1]
    lane_id = lane_ids(n, seed, state_mat.device)
    sphere_r, sphere_active = world_mat[3], world_mat[4]
    cyls = cylinder_list(cyl_mat)
    two_pi = _f32(_TWO_PI)

    def sphere_centers(i):
        cnt = world_mat[11] + float(i)
        res = torch.clamp_min(world_mat[9], 1.0)
        frac = cnt - torch.floor(cnt / res) * res
        theta = two_pi * frac / res
        has = world_mat[10] > 0.5
        cx = torch.where(has, world_mat[5] + world_mat[8] * torch.cos(theta), world_mat[0])
        cy = torch.where(has, world_mat[6] + world_mat[8] * torch.sin(theta), world_mat[1])
        cz = torch.where(has, world_mat[7], world_mat[2])
        return cx, cy, cz

    if state_mat.shape[0] != ENV_ROWS + n_pilot_rows:
        raise ValueError(f"state must have {ENV_ROWS + n_pilot_rows} rows")
    if (action_fn is None) == (action_mat is None) or (n_pilot_rows and action_fn is None):
        raise ValueError("pass exactly one of action_mat and action_fn; pilot rows need "
                         "action_fn")
    st = list(state_mat.unbind(0))
    acts = None if action_mat is None else list(action_mat.unbind(0))
    override = pilot = None
    rsum = torch.zeros(n, dtype=torch.float32, device=state_mat.device)
    crashes = torch.zeros_like(rsum)
    contacts = torch.zeros_like(rsum)
    shell = sphere_r[0] + _f32(0.3)  # motor arm 0.127 m + motor radius
    resets = torch.zeros((), dtype=torch.int64, device=state_mat.device)
    for i in range(n_steps):
        cx, cy, cz = sphere_centers(i)
        if action_fn is not None:
            acts, override, pilot = action_fn(i, st, (cx, cy, cz), sphere_r)
        spheres = list(zip(cx, cy, cz, sphere_r, sphere_active))
        dr = (st[18], st[19], st[20]) if c.randomize else None
        wnd = (st[21], st[22], st[23]) if c.use_wind else None
        phys = step_components(k, spheres, st[:STATE_ROWS], acts, cyls=cyls, dr=dr, wind=wnd,
                               override=override)

        px, py, pz = phys[0], phys[1], phys[2]
        crashed = phys[14]
        tx, ty, tz = cx[0], cy[0], cz[0]  # chased target
        ddx, ddy, ddz = px - tx, py - ty, pz - tz
        dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)

        prev_dist = st[16]
        a0, a1, a2 = acts[0], acts[1], acts[2]
        rates_pen = a0 * a0 + a1 * a1 + a2 * a2
        reward = (c.w_progress * (prev_dist - dist) + c.w_alive
                  - c.w_crash * crashed - c.w_rates * rates_pen)

        t = st[15] + 1.0
        truncated = (t >= c.max_steps).to(torch.float32)
        done = torch.maximum(crashed, truncated)

        # ---- reset draws (AcroEnv._sample_drone distributions) -------------
        base = (i + 1) * 32

        def u(d):
            return uniform_01(lane_id, base + d)

        pose, dist_r = reset_pose(c, lane_id, i, tx, ty, tz)
        ones = torch.ones_like(crashed)
        if c.randomize:
            rms = c.mass_lo + u(10) * c.mass_span
            rds = c.drag_lo + u(11) * c.drag_span
            rts = c.thrust_lo + u(12) * c.thrust_span
        else:
            rms = rds = rts = ones
        if c.gust:
            g0, g1 = normal_pair(lane_id, base + 13, base + 14)
            g2, _ = normal_pair(lane_id, base + 15, base + 16)
            rwx = c.wind[0] + c.wind_scale * g0
            rwy = c.wind[1] + c.wind_scale * g1
            rwz = c.wind[2] + c.wind_scale * g2
        else:
            rwx, rwy, rwz = (torch.full_like(crashed, w) for w in c.wind)

        zeros = torch.zeros_like(crashed)
        live = phys[:14] + [zeros, t, dist, st[17] + reward] + st[18:24] + list(pilot or [])
        reset = pose + [zeros, zeros, zeros, zeros, zeros, zeros, dist_r, zeros,
                        rms, rds, rts, rwx, rwy, rwz] + [zeros] * n_pilot_rows
        sel = done > 0.5
        st = [torch.where(sel, r, l) for r, l in zip(reset, live)]
        rsum = rsum + reward
        crashes = crashes + crashed
        contacts = contacts + crashed * (dist <= shell).to(torch.float32)
        resets = resets + sel.sum()
    if extra_metrics:
        return torch.stack(st), rsum, int(resets), crashes, contacts
    return torch.stack(st), rsum, int(resets)


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


def launch_env_rollout(env: AcroEnv, state_mat, action_mat, world_mat, n_steps: int,
                       seed: int = 0, cyl_mat=None, probe: Optional[torch.Tensor] = None):
    """K4 on the card. Returns (state (24, N), reward sum (N,)). A ``probe``
    (int64 of :data:`N_ENV_PROBE` on the card) launches the instrumented
    instantiation, which adds its phase clocks and reset count there
    (:func:`env_probe_split`)."""
    device = state_mat.device
    if device.type != "cuda":
        raise ValueError(f"env_rollout launches on a CUDA device, got {device}")
    check_cuda_inputs(device, state=state_mat, action=action_mat, world=world_mat,
                      cylinders=cyl_mat)
    if probe is not None and (probe.device != device or probe.dtype != torch.int64
                              or probe.shape != (N_ENV_PROBE,)):
        raise ValueError(f"probe must be an int64 ({N_ENV_PROBE},) tensor on {device}")
    n = state_mat.shape[1]
    if probe is not None and n >= ONE_THREAD_ENVS:
        raise ValueError(f"the instrumented K4 splits the lane design: N < {ONE_THREAD_ENVS}")
    if probe is not None and env.params.n_motors != 4:
        raise ValueError("the instrumented K4 is the quad's (n_motors=4)")
    if state_mat.shape != (ENV_ROWS, n) or action_mat.shape != (4, n):
        raise ValueError("state / action must be (24, N) / (4, N)")
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
    out = torch.empty_like(state_mat)
    rsum = torch.empty(n, dtype=torch.float32, device=device)
    S = world_mat.shape[1]
    C = 0 if cyl_mat is None else cyl_mat.shape[1]
    lanes = lib.fpyv_env_rollout_lanes(kc.ctypes.data, kc.size, S, C, n)
    log_lanes("env_rollout", lanes, n, env.params.n_motors, S, C)
    if probe is not None and lanes == 1:
        raise ValueError("the instrumented K4 splits the lane design, which this world's "
                         "staged contact terms do not fit")
    cyl_ptr = None if cyl_mat is None else cyl_mat.data_ptr()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.fpyv_env_rollout(kc.ctypes.data, kc.size, ec.ctypes.data, ec.size,
                                   int(np.int64(seed).astype(np.int32)),
                                   state_mat.data_ptr(), action_mat.data_ptr(),
                                   world_mat.data_ptr(), S, cyl_ptr, C, out.data_ptr(),
                                   rsum.data_ptr(), n, n_steps, int(c.randomize),
                                   int(c.use_wind), None if probe is None else probe.data_ptr(),
                                   stream)
    _build.check(err, "env_rollout")
    _build.launch_counts["env_rollout"] += 1
    return out, rsum


ENV_PHASES = ("centres", "head", "contacts", "tail", "env")  # EnvPhase in csrc/env_kernels.cu
N_ENV_PROBE = len(ENV_PHASES) + 1  # the phases, then the env-steps that reset
ENVS_PER_BLOCK = 32  # K4's block: 32 envs


def env_probe_split(probe: torch.Tensor, n_envs: int) -> dict:
    """An instrumented K4 launch's probe: each phase in ms a launch (the
    first thread's nanoseconds in each block, averaged over the blocks) and
    the env-steps that reset."""
    vals = probe.tolist()
    blocks = -(-n_envs // ENVS_PER_BLOCK)
    split = {name: float(v) / blocks * 1e-6 for name, v in zip(ENV_PHASES, vals)}
    split["resets"] = vals[len(ENV_PHASES)]
    return split


def env_rollout_matrix(env: AcroEnv, state_mat, action_mat, world_mat, n_steps: int,
                       seed: int = 0, cyl_mat=None):
    """K4 on CUDA tensors, its plain version on CPU tensors; returns
    (state (24, N), reward sum (N,))."""
    if state_mat.device.type == "cpu":
        out, rsum, _ = env_rollout_reference(env, state_mat, action_mat, world_mat, n_steps,
                                             seed, cyl_mat)
        return out, rsum
    return launch_env_rollout(env, state_mat, action_mat, world_mat, n_steps, seed, cyl_mat)


def fused_env_rollout(env: AcroEnv, state: AcroState, action: torch.Tensor, world: World,
                      n_steps: int, seed: int = 0) -> Tuple[AcroState, World, torch.Tensor]:
    """K full env steps in one launch; ``action`` (N, 4) applied every step.
    Returns (state, world with the target counters advanced by n_steps,
    per-env reward sum). Under ``torch.profiler`` a call is the span
    ``megaloop`` around ``megaloop.pack`` (the checks and the state, world,
    cylinder and action matrices), ``megaloop.launch`` and
    ``megaloop.unpack`` (the state and the world's counter)."""
    with span("megaloop"):
        with span("megaloop.pack"):
            if not env_supported(env, world):
                raise ValueError("the fused env needs att_mode='quat', float32 and ground")
            state_mat = env_state_to_matrix(state)
            world_mat = env_world_matrix(world)
            cyl_mat = cylinder_matrix(world) if world_has_cylinders(world) else None
            action_mat = action_matrix(action)
        with span("megaloop.launch"):
            out, rsum = env_rollout_matrix(env, state_mat, action_mat, world_mat, n_steps, seed,
                                           cyl_mat)
        with span("megaloop.unpack"):
            new_world = world.replace(
                sphere_path_count=world.sphere_path_count
                + n_steps * world.sphere_has_path.to(torch.int32))
            return matrix_to_env_state(out, state), new_world, rsum
