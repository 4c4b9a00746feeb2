"""Plain float32 reference of what one K7 (chase) or K8 (race) launch does
to its envs, written from the simulator's semantics for these two
configurations only: the quad's physics step with ground, sphere and
cylinder contact, the depth render (spheres, cylinders, ground, square
gates), the race and chase rewards, ends and respawns, and the counter-hash
noise.

Every constant is folded from the configuration file in float64 and rounded
once to float32, and every expression keeps the simulator's order of
operations, so that on the same device a correct program and this file
agree bit for bit on frames, rewards, ends and states. Divisions by a
constant divide by a device tensor: PyTorch's CUDA division by a Python
scalar multiplies by the reciprocal, which rounds otherwise.

Departures from the simulator, all deliberate:

- the race's obstacles are placed from episode time with the in-kernel
  formula ``2 pi mod(count0 + t, res) / res``; the bootstrap frame, which
  the program renders outside the kernel, uses the env's
  ``2 pi (mod / res)`` (they differ by ulps);
- only single-agent races, the quaternion attitude, no wind and no domain
  randomisation: what these two configurations run.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

F = torch.float32
BIG = 3.0e38  # "no hit"
MASK = 0xFFFFFFFF
TWO_PI = 2.0 * math.pi
DEG2RAD = math.pi / 180.0
PATCH = 8
PP = PATCH * PATCH
WORLD2CAM_T = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])


def f32(x: float) -> float:
    return float(np.float32(x))


def tdiv(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true float32 division on ``x``'s device."""
    return x / torch.tensor(d, dtype=F, device=x.device)


# ---------------------------------------------------------------------------
# Counter-hash noise: murmur3's finalizer over (env lane, counter)
# ---------------------------------------------------------------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def lanes(n: int, seed: int, device) -> torch.Tensor:
    s = fmix(torch.tensor(seed & MASK, dtype=torch.int64, device=device))
    return fmix(torch.arange(n, dtype=torch.int64, device=device) ^ s)


def uniform(lane: torch.Tensor, ctr: int) -> torch.Tensor:
    bits = fmix(lane ^ ((ctr * 0x9E3779B9) & MASK))
    return (bits >> 8).to(F) * (1.0 / (1 << 24))


def normals(lane: torch.Tensor, ca: int, cb: int):
    u1 = torch.clamp_min(uniform(lane, ca), f32(1e-12))
    u2 = uniform(lane, cb)
    r = torch.sqrt(-2.0 * torch.log(u1))
    a = f32(TWO_PI) * u2
    return r * torch.cos(a), r * torch.sin(a)


# ---------------------------------------------------------------------------
# Physics: one step of the quad (quaternion attitude, contact springs)
# ---------------------------------------------------------------------------


class Physics:
    def __init__(self, d: Dict):
        a, b = d["rates_transition_rate"], d["thrust_transition_rate"]
        k = -0.5 * d["air_density"]
        self.dt, self.mr = f32(d["dt"]), f32(d["max_rates"])
        self.ra, self.rk, self.tb, self.tk = f32(a), f32(1 - a), f32(b), f32(1 - b)
        self.poly = [f32(c) for c in d["throttle2thrust_coeffs"]]
        self.drag = [f32(k * cd * ar) for cd, ar in zip(d["drag_coef"], d["cross_sections"])]
        self.gz, self.inv_m = f32(-d["gravity"] * d["mass"]), f32(1.0 / d["mass"])
        self.half_rate = f32(0.5 * DEG2RAD * d["dt"])
        self.rm, self.spring = f32(d["motor_radius"]), -float(d["contact_spring"])
        n = d["n_motors"]
        r = d["arm_radius_in"] * 2.54 / 100.0
        t = np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
        t = t + (t[1] - t[0]) / 2.0
        self.motors = [(f32(r * np.cos(x)), f32(r * np.sin(x))) for x in t]
        self.reps = 2 if d["double_rotation_quirk"] else 1
        self.inv_max_rates = f32(1.0 / d["max_rates"])
        self.inv_max_force = f32(1.0 / d["max_force"])
        self.max_rates, self.max_force = float(d["max_rates"]), float(d["max_force"])

    def step(self, s: Sequence[torch.Tensor], act: Sequence[torch.Tensor], spheres=(),
             cyls=()) -> List[torch.Tensor]:
        """15 state rows (pos, vel, quat, rates, thrust, done) and 4 action
        rows -> the 15 next rows and the world-z acceleration."""
        px, py, pz, vx, vy, vz, qw, qx, qy, qz, r0, r1, r2, thr, done = s
        mr = self.mr
        n = [torch.clamp(-act[j] * mr, -mr, mr) * self.ra + r * self.rk
             for j, r in enumerate((r0, r1, r2))]
        x = 100.0 * (torch.clamp(act[3], -1.0, 1.0) + 1.0) * 0.5
        c3, c2, c1, c0 = self.poly
        thrust = (((c3 * x + c2) * x + c1) * x + c0) * self.tb + thr * self.tk
        R00 = 1 - 2 * (qy * qy + qz * qz)
        R01 = 2 * (qx * qy - qz * qw)
        R02 = 2 * (qx * qz + qy * qw)
        R10 = 2 * (qx * qy + qz * qw)
        R11 = 1 - 2 * (qx * qx + qz * qz)
        R12 = 2 * (qy * qz - qx * qw)
        R20 = 2 * (qx * qz - qy * qw)
        R21 = 2 * (qy * qz + qx * qw)
        R22 = 1 - 2 * (qx * qx + qy * qy)
        vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
        fb = [self.drag[0] * (R00 * vx + R10 * vy + R20 * vz) * vn,
              self.drag[1] * (R01 * vx + R11 * vy + R21 * vz) * vn,
              self.drag[2] * (R02 * vx + R12 * vy + R22 * vz) * vn]
        dx = R00 * fb[0] + R01 * fb[1] + R02 * fb[2]
        dy = R10 * fb[0] + R11 * fb[1] + R12 * fb[2]
        dz = R20 * fb[0] + R21 * fb[1] + R22 * fb[2]
        rm, k = self.rm, self.spring
        cfx, cfy, cfz, crashed = (torch.zeros_like(px) for _ in range(4))
        for m0, m1 in self.motors:
            mx = px + R00 * m0 + R01 * m1
            my = py + R10 * m0 + R11 * m1
            mz = pz + R20 * m0 + R21 * m1
            pen = mz - rm
            cfz = cfz + (pen < 0).to(F) * (k * pen)
            crashed = torch.maximum(crashed, (mz < 0).to(F))
            for sx, sy, sz, sr, on in spheres:
                ex, ey, ez = mx - sx, my - sy, mz - sz
                dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
                sd = dist - sr
                inv = 1.0 / torch.clamp_min(dist, 1e-12)
                pen_s = sd - rm
                hit, mag = (pen_s < 0).to(F) * on, k * pen_s
                cfx = cfx + hit * mag * ex * inv
                cfy = cfy + hit * mag * ey * inv
                cfz = cfz + hit * mag * ez * inv
                crashed = torch.maximum(crashed, (sd < 0).to(F) * on)
            for cx, cy, cz, cr, ch, on in cyls:
                ex, ey = mx - cx, my - cy
                r2d = torch.sqrt(ex * ex + ey * ey)
                d2d = r2d - cr
                z0, z1 = cz, cz + ch
                band = ((z0 < mz) & (mz < z1)).to(F)
                dh = torch.minimum(torch.abs(mz - z0), torch.abs(mz - z1))
                d = band * d2d + (1 - band) * torch.sqrt(d2d * d2d + dh * dh)
                # the normal takes z relative to the base against the absolute band
                relz = mz - cz
                band_n = ((z0 < relz) & (relz < z1)).to(F)
                inv2d = 1.0 / torch.clamp_min(r2d, 1e-12)
                cap = torch.where(torch.abs(relz - z0) < torch.abs(relz - z1), -1.0, 1.0).to(F)
                pen_c = d - rm
                hit, mag = (pen_c < 0).to(F) * on, k * pen_c
                cfx = cfx + hit * mag * (band_n * ex * inv2d)
                cfy = cfy + hit * mag * (band_n * ey * inv2d)
                cfz = cfz + hit * mag * ((1 - band_n) * cap)
                crashed = torch.maximum(crashed, (d < 0).to(F) * on)
        im, dt = self.inv_m, self.dt
        acx = (R02 * thrust + dx + cfx) * im
        acy = (R12 * thrust + dy + cfy) * im
        acz = (R22 * thrust + dz + self.gz + cfz) * im
        out = [px + vx * dt, py + vy * dt, pz + vz * dt, vx + acx * dt, vy + acy * dt,
               vz + acz * dt]
        h = [nj * self.half_rate for nj in n]
        cr, sr, cp, sp, cy, sy = (torch.cos(h[0]), torch.sin(h[0]), torch.cos(h[1]),
                                  torch.sin(h[1]), torch.cos(h[2]), torch.sin(h[2]))
        ew = cy * cp * cr + sy * sp * sr
        ex = cy * cp * sr - sy * sp * cr
        ey = cy * sp * cr + sy * cp * sr
        ez = sy * cp * cr - cy * sp * sr
        for _ in range(self.reps):
            qw, qx, qy, qz = (qw * ew + qx * ex + qy * ey + qz * ez,
                              -qw * ex + qx * ew - qy * ez + qz * ey,
                              -qw * ey + qx * ez + qy * ew - qz * ex,
                              -qw * ez - qx * ey + qy * ex + qz * ew)
        qn = 1.0 / torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
        return out + [qw * qn, qx * qn, qy * qn, qz * qn] + n + [
            thrust, torch.maximum(done, crashed), acz]


# ---------------------------------------------------------------------------
# The camera and the depth render
# ---------------------------------------------------------------------------


class Camera:
    def __init__(self, c: Dict, device):
        W, H = c["resolution"]
        f = W / (2.0 * np.tan(np.deg2rad(c["fov_deg"]) / 2.0))
        K_inv = np.linalg.inv(np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]]))
        uu, vv = np.meshgrid(np.arange(W, dtype=np.float64) + 0.5,
                             np.arange(H, dtype=np.float64) + 0.5)
        d = np.stack([K_inv[0, 0] * uu + K_inv[0, 1] * vv + K_inv[0, 2],
                      K_inv[1, 1] * vv + K_inv[1, 2], np.ones_like(uu)]).astype(np.float32)
        # patch-major pixel order: 8x8 patches row-major, pixels row-major in each
        d = np.moveaxis(d.reshape(3, H // PATCH, PATCH, W // PATCH, PATCH), 2, 3)
        self.rays = torch.from_numpy(np.ascontiguousarray(d.reshape(3, -1))).to(device)
        cp, sp = np.cos(np.deg2rad(c["pitch_deg"])), np.sin(np.deg2rad(c["pitch_deg"]))
        mount = WORLD2CAM_T @ np.array([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
        self.mount = [f32(x) for x in mount.reshape(-1)]
        self.rel = [f32(x) for x in c["rel_position"]]
        self.max_depth, self.frame_width = f32(c["max_depth"]), f32(c["frame_width"])
        self.n_patches = (W * H) // PP

    def pose(self, s: Sequence[torch.Tensor], frame_path: bool = False):
        """(camera position (3 rows), camera rotation (9 rows, row major))
        from the state's position and quaternion rows: as the kernels pose
        the camera, or with ``frame_path`` as the frame renderer's caller
        does (the rotation matrix first, then R mount and p + R rel)."""
        px, py, pz, qw, qx, qy, qz = s[0], s[1], s[2], s[6], s[7], s[8], s[9]
        m, r = self.mount, self.rel
        if frame_path:
            B = [1 - 2 * qy * qy - 2 * qz * qz, 2 * qx * qy - 2 * qz * qw,
                 2 * qx * qz + 2 * qy * qw, 2 * qx * qy + 2 * qz * qw,
                 1 - 2 * qx * qx - 2 * qz * qz, 2 * qy * qz - 2 * qx * qw,
                 2 * qx * qz - 2 * qy * qw, 2 * qy * qz + 2 * qx * qw,
                 1 - 2 * qx * qx - 2 * qy * qy]
            p = [pos + (B[3 * i] * r[0] + B[3 * i + 1] * r[1] + B[3 * i + 2] * r[2])
                 for i, pos in enumerate((px, py, pz))]
        else:
            B = [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw),
                 2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw),
                 2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)]
            p = [pos + B[3 * i] * r[0] + B[3 * i + 1] * r[1] + B[3 * i + 2] * r[2]
                 for i, pos in enumerate((px, py, pz))]
        R = [B[3 * i] * m[j] + B[3 * i + 1] * m[3 + j] + B[3 * i + 2] * m[6 + j]
             for i in range(3) for j in range(3)]
        return p, R

    def levels(self, s, spheres=(), cyls=(), gates=(), frame_path: bool = False) -> torch.Tensor:
        """Depth levels ``floor(255 (1 - t / max_depth))`` (N, pixels) as
        float32, of the nearest hit of each ray. ``spheres`` holds (cx, cy,
        cz, r, active) and ``cyls`` (cx, cy, z0, r, h, active) as (N, 1) or
        (1, 1) columns; ``gates`` (pos 3, normal 3, ey 3, ez 3, size) as
        floats."""
        p, R = self.pose(s, frame_path)
        px, py, pz = (c[:, None] for c in p)
        R = [c[:, None] for c in R]
        d = self.rays
        dwx = R[0] * d[0:1] + R[1] * d[1:2] + R[2] * d[2:3]
        dwy = R[3] * d[0:1] + R[4] * d[1:2] + R[5] * d[2:3]
        dwz = R[6] * d[0:1] + R[7] * d[1:2] + R[8] * d[2:3]
        big = torch.tensor(BIG, dtype=F, device=dwx.device)
        t_min = torch.full(dwx.shape, BIG, dtype=F, device=dwx.device)
        a = dwx * dwx + dwy * dwy + dwz * dwz
        for cx, cy, cz, r, on in spheres:
            ox, oy, oz = px - cx, py - cy, pz - cz
            b = ox * dwx + oy * dwy + oz * dwz
            c = ox * ox + oy * oy + oz * oz - r * r
            disc = b * b - a * c
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            t = (-b - sq) / a
            t = torch.where(t > 0, t, (-b + sq) / a)
            t_min = torch.minimum(t_min, torch.where((disc >= 0) & (t > 0) & (on > 0.5), t, big))
        if cyls:
            a2 = dwx * dwx + dwy * dwy
            a2 = torch.where(torch.abs(a2) > 1e-20, a2, torch.full_like(a2, 1e-20))
        for cx, cy, z0, r, h, on in cyls:
            ox, oy = px - cx, py - cy
            b = ox * dwx + oy * dwy
            disc = b * b - a2 * (ox * ox + oy * oy - r * r)
            sq = torch.sqrt(torch.clamp_min(disc, 0.0))
            t_near = (-b - sq) / a2
            t_far = (-b + sq) / a2
            z_near, z_far = pz + t_near * dwz, pz + t_far * dwz
            near = (disc >= 0) & (t_near > 0) & (z_near >= z0) & (z_near <= z0 + h)
            far = (disc >= 0) & (t_far > 0) & (z_far >= z0) & (z_far <= z0 + h)
            t = torch.where(near, t_near, t_far)
            t_min = torch.minimum(t_min, torch.where((near | far) & (on > 0.5), t, big))
        safe = torch.where(torch.abs(dwz) > 1e-20, dwz, torch.full_like(dwz, 1e-20))
        t = -pz / safe  # the ground, in every world of these configurations
        t_min = torch.minimum(t_min, torch.where((t > 0) & (torch.abs(dwz) > 1e-20), t, big))
        fw = self.frame_width
        for gx, gy, gz, nx, ny, nz, yx, yy, yz, zx, zy, zz, size in gates:
            ndotd = nx * dwx + ny * dwy + nz * dwz
            ndot0 = nx * (gx - px) + ny * (gy - py) + nz * (gz - pz)
            t = ndot0 / torch.where(torch.abs(ndotd) > 1e-20, ndotd, torch.full_like(ndotd, 1e-20))
            hx, hy, hz = px + t * dwx - gx, py + t * dwy - gy, pz + t * dwz - gz
            ly = yx * hx + yy * hy + yz * hz
            lz = zx * hx + zy * hy + zz * hz
            frame = torch.abs(torch.maximum(torch.abs(ly), torch.abs(lz)) - size * 0.5) <= fw
            t_min = torch.minimum(t_min, torch.where(
                (t > 0) & frame & (torch.abs(ndotd) > 1e-20), t, big))
        md = self.max_depth
        lev = torch.floor(255.0 * (1.0 - tdiv(torch.clamp_max(t_min, md), md)))
        return torch.clamp(lev, 0.0, 255.0)


# ---------------------------------------------------------------------------
# The two envs around the physics
# ---------------------------------------------------------------------------


class RaceEnv:
    """The single-agent race of K8 over the (N, 22) state columns: pos 0:3,
    vel 3:6, quat 6:10, rates 10:13, thrust 13, crashed 14, t 15,
    next_gate 16, prev_center_dist 17, accel_z 18, gates_passed 19,
    prev_gate_dist 20, flush 21."""

    def __init__(self, cfg: Dict, device):
        r, self.device = cfg["race"], device
        self.phys, self.cam = Physics(cfg["drone"]), Camera(cfg["camera"], device)
        G = self.G = r["n_gates"]
        theta = np.linspace(0, 2 * np.pi, G + 1)[:-1]
        self.gates = []
        for t in theta:
            c, s = np.cos(t + np.pi / 2), np.sin(t + np.pi / 2)
            rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            pos = [np.cos(t) * r["track_radius"], np.sin(t) * r["track_radius"], r["gate_height"]]
            self.gates.append([f32(x) for x in pos] + [f32(x) for x in rot.T.reshape(-1)]
                              + [f32(r["gate_size"])])
        S, P = r["n_obstacles"], r["obstacle_period"]
        self.obstacles = [(float((s * P) // max(S, 1)), f32(r["track_radius"]), float(P),
                           f32(r["gate_height"]), f32(r["obstacle_radius"])) for s in range(S)]
        self.K, self.onehot = r["frame_stack"], 1.0 if r["gate_onehot"] else 0.0
        self.max_steps = f32(r["max_episode_steps"])
        self.w = [f32(r[k]) for k in ("w_gate", "w_progress", "w_alive", "w_crash")]
        self.spawn = (f32(r["track_radius"] + r["spawn_radius"]), f32(-3.0 - r["spawn_radius"]),
                      f32(r["spawn_height"]))
        self.jitter, self.sq2h = f32(r["spawn_jitter"]), f32(math.sqrt(0.5))
        self.inv_30 = f32(1.0 / 30.0)
        self.log_2pi2 = f32(2.0 * math.log(2.0 * math.pi))

    def _col(self, x: float) -> torch.Tensor:
        return torch.tensor([x], dtype=F, device=self.device)

    def obstacles_at(self, t: torch.Tensor, env_formula: bool = False):
        """(cx, cy, cz, r, active) per obstacle at episode time t (N,)."""
        out = []
        for count0, radius, res, height, r in self.obstacles:
            res_t = self._col(max(res, 1.0))
            if env_formula:
                theta = f32(TWO_PI) * (torch.remainder(t + count0, res_t) / res_t)
                cx, cy = torch.cos(theta) * radius, torch.sin(theta) * radius
            else:
                theta = f32(TWO_PI) * torch.remainder(self._col(count0) + t, res_t) / res_t
                cx, cy = radius * torch.cos(theta), radius * torch.sin(theta)
            ones = torch.ones_like(cx)
            out.append((cx, cy, height * ones, r * ones, ones))
        return out

    def render(self, s, env_formula: bool = False) -> torch.Tensor:
        sph = [tuple(v[:, None] for v in o) for o in self.obstacles_at(s[15], env_formula)]
        return self.cam.levels(s, spheres=sph, gates=self.gates, frame_path=env_formula)

    def proprio(self, s) -> List[torch.Tensor]:
        p = self.phys
        mask = [(torch.abs(s[16] - g) < 0.5).to(F) * self.onehot for g in range(self.G)]
        return [s[10] * p.inv_max_rates, s[11] * p.inv_max_rates, s[12] * p.inv_max_rates,
                s[18] * self.inv_30, s[13] * p.inv_max_force] + mask

    def step(self, s, act, lane, i: int):
        """One env step with actions ``act`` (4 rows): (next state rows,
        reward, env end)."""
        phys = self.phys.step(s[:15], act, spheres=self.obstacles_at(s[15] + 1.0))
        crashed = phys[14]
        gt = torch.tensor(self.gates, dtype=F, device=self.device)  # (G, 13)
        g1 = gt[s[16].long()]
        rx, ry, rz = phys[0] - g1[:, 0], phys[1] - g1[:, 1], phys[2] - g1[:, 2]
        plane_d = rx * g1[:, 3] + ry * g1[:, 4] + rz * g1[:, 5]
        lateral = torch.sqrt(torch.clamp_min((rx * rx + ry * ry + rz * rz) - plane_d * plane_d, 0.0))
        center_d = torch.sqrt(rx * rx + ry * ry + rz * rz)
        passed = ((s[20] < 0).to(F) * (plane_d >= 0).to(F) * (lateral < g1[:, 12] * 0.5).to(F)
                  * (1.0 - crashed))
        ng = torch.remainder(s[16] + passed, float(self.G))
        g2 = gt[ng.long()]
        qx, qy, qz = phys[0] - g2[:, 0], phys[1] - g2[:, 1], phys[2] - g2[:, 2]
        plane_new = qx * g2[:, 3] + qy * g2[:, 4] + qz * g2[:, 5]
        center_new = torch.sqrt(qx * qx + qy * qy + qz * qz)
        wg, wp, wa, wc = self.w
        reward = (wg * passed + wp * ((1.0 - passed) * (s[17] - center_d)) + wa * (1.0 - crashed)
                  - wc * (crashed * (1.0 - s[14])))
        t_next = s[15] + 1.0
        end = torch.maximum(crashed, (t_next >= self.max_steps).to(F))
        base = (i + 1) * 32
        j0, j1 = normals(lane, base + 0, base + 1)
        j2, _ = normals(lane, base + 2, base + 3)
        sx = self.spawn[0] + self.jitter * j0
        sy = self.spawn[1] + self.jitter * j1
        sz = self.spawn[2] + self.jitter * j2
        g0 = gt[0]
        d0x, d0y, d0z = sx - g0[0], sy - g0[1], sz - g0[2]
        zero = torch.zeros_like(sx)
        live = phys[:15] + [t_next, ng, center_new, phys[15], s[19] + passed, plane_new, zero]
        reset = ([sx, sy, sz] + [zero] * 3 + [zero + self.sq2h, zero, zero, zero + self.sq2h]
                 + [zero] * 7 + [torch.sqrt(d0x * d0x + d0y * d0y + d0z * d0z), zero, zero,
                                 d0x * g0[3] + d0y * g0[4] + d0z * g0[5], zero + 1.0])
        sel = end > 0.5
        return [torch.where(sel, r_, l_) for r_, l_ in zip(reset, live)], reward, end


class ChaseEnv:
    """K7's chase over the (N, 18) state columns: pos 0:3, vel 3:6, quat
    6:10, rates 10:13, thrust 13, crashed 14, t 15, prev_dist 16, accel_z
    17; every env in its own world (target sphere, cylinders, ground)."""

    def __init__(self, cfg: Dict, world: Dict[str, torch.Tensor], device):
        c, self.device = cfg["chase"], device
        self.phys, self.cam = Physics(cfg["drone"]), Camera(cfg["camera"], device)
        w = world
        self.spheres = [tuple(w["sphere"][:, s, j] for j in range(5))
                        for s in range(w["sphere"].shape[1])]
        self.cyls = [tuple(w["cyl"][:, k, j] for j in range(6)) for k in range(w["cyl"].shape[1])]
        self.pos_low = [f32(x) for x in c["pos_low"]]
        self.pos_span = [f32(h - l) for l, h in zip(c["pos_low"], c["pos_high"])]
        self.vel_scale, self.half_ypr = f32(c["vel_scale"]), f32(0.5 * DEG2RAD * c["ypr_range_deg"])
        self.max_steps = f32(c["max_episode_steps"])
        self.w = [f32(c[k]) for k in ("w_progress", "w_alive", "w_crash", "w_rates")]
        self.inv_30 = f32(1.0 / 30.0)
        self.log_2pi2 = f32(2.0 * math.log(2.0 * math.pi))

    def render(self, s, env_formula: bool = False) -> torch.Tensor:
        col = [tuple(v[:, None] for v in sp) for sp in self.spheres]
        cyl = [tuple(v[:, None] for v in cy) for cy in self.cyls]
        return self.cam.levels(s, spheres=col, cyls=cyl, frame_path=env_formula)

    def proprio(self, s) -> List[torch.Tensor]:
        p = self.phys
        return [s[10] * p.inv_max_rates, s[11] * p.inv_max_rates, s[12] * p.inv_max_rates,
                s[17] * self.inv_30, s[13] * p.inv_max_force]

    def step(self, s, act, lane, i: int):
        """One env step: (next state rows, reward, crash flag)."""
        phys = self.phys.step(s[:15], act, spheres=self.spheres, cyls=self.cyls)
        crashed = phys[14]
        tx, ty, tz = self.spheres[0][:3]
        ex, ey, ez = phys[0] - tx, phys[1] - ty, phys[2] - tz
        dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
        wp, wa, wc, wr = self.w
        reward = (wp * (s[16] - dist) + wa - wc * crashed
                  - wr * (act[0] * act[0] + act[1] * act[1] + act[2] * act[2]))
        t_next = s[15] + 1.0
        end = torch.maximum(crashed, (t_next >= self.max_steps).to(F))
        base = (i + 1) * 32

        def u(k):
            return uniform(lane, base + k)

        pos = [self.pos_low[k] + u(k) * self.pos_span[k] for k in range(3)]
        z0, z1 = normals(lane, base + 3, base + 4)
        z2, _ = normals(lane, base + 5, base + 6)
        h = [(2.0 * u(7 + k) - 1.0) * self.half_ypr for k in range(3)]
        cr, sr, cp, sp, cy, sy = (torch.cos(h[0]), torch.sin(h[0]), torch.cos(h[1]),
                                  torch.sin(h[1]), torch.cos(h[2]), torch.sin(h[2]))
        rx, ry, rz = pos[0] - tx, pos[1] - ty, pos[2] - tz
        zero = torch.zeros_like(dist)
        reset = pos + [self.vel_scale * z0, self.vel_scale * z1, self.vel_scale * z2,
                       cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                       cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr] + [zero] * 6 + [
            torch.sqrt(rx * rx + ry * ry + rz * rz), zero]
        live = phys[:14] + [zero, t_next, dist, phys[15]]
        sel = end > 0.5
        return [torch.where(sel, r_, l_) for r_, l_ in zip(reset, live)], reward, crashed


# ---------------------------------------------------------------------------
# Starts: the draws the trainers make at set-up, from the seed
# ---------------------------------------------------------------------------


def trainer_generators(seed: int):
    """The trainers' four CPU generators (worlds, env resets, net, training)
    from ``seed``, as ``numpy.random.SeedSequence`` spreads it."""
    return [torch.Generator().manual_seed(int(s))
            for s in np.random.SeedSequence(seed).generate_state(4)]


def chase_worlds(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every env's world: ``sphere`` (N, S, 5) [cx cy cz r active] and
    ``cyl`` (N, C, 6) [cx cy z0 r h active], drawn from the worlds'
    generator in the order the trainer draws them."""
    w, n = cfg["world"], cfg["num_envs"]
    S, C = w["n_spheres"], w["n_cylinders"]
    g = trainer_generators(seed)[0]

    def unif(shape, lo, hi):
        return lo + torch.rand(shape, generator=g, dtype=F) * (hi - lo)

    center = torch.tensor(w["target_center"], dtype=F) + w["target_center_std"] * torch.randn(
        (n, S, 3), generator=g, dtype=F)
    radius = unif((n, S), *w["target_radius"])
    unif((n, S), *w["target_path_radius"])  # the path: K7 holds its targets still
    xy = w["cyl_xy_std"] * torch.randn((n, C, 2), generator=g, dtype=F)
    cr, ch = unif((n, C), *w["cyl_radius"]), unif((n, C), *w["cyl_height"])
    ones = torch.ones((n, S), dtype=F)
    sphere = torch.cat([center, radius[..., None], ones[..., None]], dim=-1)
    cyl = torch.stack([xy[..., 0], xy[..., 1], torch.zeros_like(cr), cr, ch,
                       torch.ones_like(cr)], dim=-1)
    return {"sphere": sphere.to(device), "cyl": cyl.to(device)}


def _quat_from_euler_deg(ypr: torch.Tensor) -> torch.Tensor:
    half = 0.5 * torch.deg2rad(ypr)
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                        cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr], dim=-1)


def race_start(cfg: Dict, seed: int, device) -> torch.Tensor:
    """The fresh races' (N, 22) state columns (flush 0: the trainer fills
    the history with the first frame), computed on ``device`` in the
    trainer's order."""
    r, n = cfg["race"], cfg["num_envs"]
    g = trainer_generators(seed)[1]
    jitter = (r["spawn_jitter"] * torch.randn((n, 1, 3), generator=g, dtype=F)).to(device)
    one = torch.ones((1,), dtype=F, device=device)
    base = torch.stack([r["track_radius"] + one * r["spawn_radius"],
                        -3.0 - r["spawn_radius"] + 0.0 * one,
                        torch.full((1,), r["spawn_height"], dtype=F, device=device)], dim=-1)
    pos = (base + jitter)[:, 0]
    quat = _quat_from_euler_deg(torch.tensor([[0.0, 0.0, 90.0]], dtype=F, device=device))
    gate0 = torch.tensor([r["track_radius"], 0.0, r["gate_height"]], dtype=F, device=device)
    normal = torch.tensor([np.cos(np.pi / 2), np.sin(np.pi / 2), 0.0], dtype=F, device=device)
    z = torch.zeros((n, 1), dtype=F, device=device)
    return torch.cat([pos, z, z, z, quat.expand(n, 4), z, z, z, z, z, z, z,
                      torch.linalg.vector_norm(gate0 - pos, dim=-1, keepdim=True), z, z,
                      torch.sum((pos - gate0) * normal, dim=-1, keepdim=True), z], dim=1)


def chase_start(cfg: Dict, seed: int, target: torch.Tensor) -> torch.Tensor:
    """The fresh envs' (N, 18) state columns, on ``target``'s device (N, 3),
    in the trainer's order."""
    c, n = cfg["chase"], cfg["num_envs"]
    g = trainer_generators(seed)[1]
    device = target.device
    lo, hi = torch.tensor(c["pos_low"], dtype=F), torch.tensor(c["pos_high"], dtype=F)
    pos = (lo + torch.rand((n, 3), generator=g, dtype=F) * (hi - lo)).to(device)
    vel = c["vel_scale"] * torch.randn((n, 3), generator=g, dtype=F).to(device)
    a = torch.tensor(c["ypr_range_deg"], dtype=F)
    ypr = (-a + torch.rand((n, 3), generator=g, dtype=F) * (a - -a)).to(device)
    z = torch.zeros((n, 1), dtype=F, device=device)
    return torch.cat([pos, vel, _quat_from_euler_deg(ypr), z, z, z, z, z, z,
                      torch.linalg.vector_norm(target - pos, dim=-1, keepdim=True), z], dim=1)
