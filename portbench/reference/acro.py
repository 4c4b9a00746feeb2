"""Plain float32 reference of what one launch of the acro megaloop does to
its bank, written from the simulator's semantics for the ``acro_dr_wind``
configuration: the quad's physics step with per-env domain randomisation
(mass, drag and thrust scales) and wind, ground, a target sphere on its
circular path and cylinder contact; the chase reward with the t,
prev_dist and return rows; truncation and crash; and the auto-reset with
its counter-hash draws (pose, Box-Muller velocity, yaw/pitch/roll, the
domain randomisation and the wind gust). Also the bank's start and the
world, both drawn from the run's seed as the program's set-up draws them.

Constants are folded from the configuration file in float64 and rounded
once to float32 (``sim.Physics``'s), and every expression keeps the
simulator's order of operations, so that on the same device a correct
program and this file agree bit for bit. The motor points' contact terms
are computed for all motors and cylinders at once and then summed one by
one in the simulator's order (per motor: the ground, the spheres, the
cylinders).

Step ``i`` of a launch draws from counters ``(i + 1) * 32 + d`` of each
env's lane (``sim.lanes`` of the launch's seed): d 0-2 the position, 3-6
two Box-Muller pairs for the velocity, 7-9 yaw/pitch/roll, 10-12 the mass,
drag and thrust scales, 13-16 two pairs for the gust. The target of step
``i`` stands at ``count + i`` of its path's resolution, ``count`` being the
world's path counter at the launch, reduced modulo the resolution.

A bank is (24, N) rows: pos 0:3, vel 3:6, quat 6:10, rates 10:13, thrust
13, done 14, t 15, prev_dist 16, return 17, the mass, drag and thrust
scales 18:21, the wind 21:24.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import sim
from portbench.reference.check import relgap

F = torch.float32


@dataclass
class MegaLaunch:
    """One call of the megaloop as a driver recorded it."""

    call: int  # the call's index in the run (the set-up call is 0)
    seed: int  # the kernel's seed
    cols: torch.Tensor  # (24, N) the input state
    cols_out: torch.Tensor  # (24, N) the output state
    reward: torch.Tensor  # (N,) the reward sum over the launch
    done: Optional[torch.Tensor] = None  # (K, N) the reference's reset flags, set by the check


def world(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The targets and cylinders that ``params.yaml``'s generators draw from
    ``numpy.random.default_rng(seed)``, in their order: each target's
    centre and radius, then each cylinder's base, radius and height.
    Returns float32 columns: ``sphere`` (S, 5) [cx cy cz r active],
    ``path`` (S, 5) [centre xyz, radius, resolution] and ``cyl`` (C, 6)
    [cx cy z0 r h active]."""
    t, o = cfg["world"]["targets"], cfg["world"]["obstacles"]
    rng = np.random.default_rng(seed)
    sphere, path, cyl = [], [], []
    for _ in range(t["count"]):
        c = np.asarray(t["center"], np.float64) + t["std"] * rng.standard_normal(3)
        r = abs(t["size"] + t["variation"] * rng.standard_normal())
        sphere.append([*c, r, 1.0])
        path.append([*c, t["path"]["radius"], t["path"]["resolution"]])
    for _ in range(o["count"]):
        c = (np.asarray(o["center"], np.float64)
             + np.asarray(o["center_std"], np.float64) * rng.standard_normal(3))
        r = abs(o["radius"] + o["radius_std"] * rng.standard_normal())
        h = abs(o["height"] + o["height_std"] * rng.standard_normal())
        cyl.append([*c, r, h, 1.0])

    def t32(rows, width):
        return torch.tensor(np.asarray(rows, np.float64).reshape(-1, width), dtype=F,
                            device=device)

    return {"sphere": t32(sphere, 5), "path": t32(path, 5), "cyl": t32(cyl, 6)}


def start(cfg: Dict, seed: int, wld: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The fresh bank's (24, N) rows, drawn from a CPU generator seeded with
    ``seed`` in the env's order (position, velocity, yaw/pitch/roll, the
    three scales, the wind) and finished on the world's device."""
    a, n = cfg["acro"], cfg["num_envs"]
    device = wld["sphere"].device
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.tensor(a["pos_low"], dtype=F), torch.tensor(a["pos_high"], dtype=F)
    pos = (lo + torch.rand((n, 3), generator=g, dtype=F) * (hi - lo)).to(device)
    vel = a["vel_scale"] * torch.randn((n, 3), generator=g, dtype=F).to(device)
    y = torch.tensor(a["ypr_range_deg"], dtype=F)
    ypr = (-y + torch.rand((n, 3), generator=g, dtype=F) * (y - -y)).to(device)
    if a["randomize"]:
        scales = [(r[0] + torch.rand((n,), generator=g, dtype=F) * (r[1] - r[0])).to(device)
                  for r in (a["mass_range"], a["drag_range"], a["thrust_range"])]
    else:
        scales = [torch.ones(n, dtype=F, device=device) for _ in range(3)]
    wind = torch.tensor(a["wind"], dtype=F, device=device).expand(n, 3)
    if a["wind_scale"] > 0:
        wind = wind + a["wind_scale"] * torch.randn((n, 3), generator=g, dtype=F).to(device)
    quat = sim._quat_from_euler_deg(ypr)
    dist = torch.linalg.vector_norm(wld["sphere"][0, :3] - pos, dim=-1)
    z = torch.zeros(n, dtype=F, device=device)
    return torch.stack([*pos.T, *vel.T, *quat.T, z, z, z, z, z, z, dist, z, *scales, *wind.T])


class Quad(sim.Physics):
    """``sim.Physics``'s constants and step, with each env's mass, drag and
    thrust scales and the wind in the drag."""

    def __init__(self, d: Dict, device):
        super().__init__(d)
        self.mass = sim.f32(d["mass"])
        m = torch.tensor(self.motors, dtype=F, device=device)
        self.mx, self.my = m[:, 0:1], m[:, 1:2]  # (M, 1)

    def step(self, s, act, spheres, cyl, dr=None, wind=None) -> List[torch.Tensor]:
        """15 state rows and 4 action rows -> the 15 next rows; ``spheres``
        is a list of (cx, cy, cz, r, active), ``cyl`` (C, 6) columns,
        ``dr`` the (mass, drag, thrust) scale rows, ``wind`` its 3 rows."""
        px, py, pz, vx, vy, vz, qw, qx, qy, qz, r0, r1, r2, thr, done = s
        mr = self.mr
        n = [torch.clamp(-act[j] * mr, -mr, mr) * self.ra + r * self.rk
             for j, r in enumerate((r0, r1, r2))]
        x = 100.0 * (torch.clamp(act[3], -1.0, 1.0) + 1.0) * 0.5
        c3, c2, c1, c0 = self.poly
        thrust = (((c3 * x + c2) * x + c1) * x + c0) * self.tb + thr * self.tk
        if dr is not None:
            thrust = thrust * dr[2]
        R00 = 1 - 2 * (qy * qy + qz * qz)
        R01 = 2 * (qx * qy - qz * qw)
        R02 = 2 * (qx * qz + qy * qw)
        R10 = 2 * (qx * qy + qz * qw)
        R11 = 1 - 2 * (qx * qx + qz * qz)
        R12 = 2 * (qy * qz - qx * qw)
        R20 = 2 * (qx * qz - qy * qw)
        R21 = 2 * (qy * qz + qx * qw)
        R22 = 1 - 2 * (qx * qx + qy * qy)
        # the drag acts on the velocity relative to the air
        ax, ay, az = (vx, vy, vz) if wind is None else (vx + wind[0], vy + wind[1],
                                                       vz + wind[2])
        vn = torch.sqrt(ax * ax + ay * ay + az * az)
        fb = [self.drag[0] * (R00 * ax + R10 * ay + R20 * az) * vn,
              self.drag[1] * (R01 * ax + R11 * ay + R21 * az) * vn,
              self.drag[2] * (R02 * ax + R12 * ay + R22 * az) * vn]
        dx = R00 * fb[0] + R01 * fb[1] + R02 * fb[2]
        dy = R10 * fb[0] + R11 * fb[1] + R12 * fb[2]
        dz = R20 * fb[0] + R21 * fb[1] + R22 * fb[2]
        gz = self.gz
        if dr is not None:
            dx, dy, dz = dx * dr[1], dy * dr[1], dz * dr[1]
            gz = gz * dr[0]
        terms, crash = self._contacts(px, py, pz, R00, R01, R10, R11, R20, R21, spheres, cyl)
        cfx, cfy, cfz = (torch.zeros_like(px) for _ in range(3))
        for tx_, ty_, tz_ in terms:  # the simulator's order of the sums
            if tx_ is not None:  # the ground pushes along z alone
                cfx, cfy = cfx + tx_, cfy + ty_
            cfz = cfz + tz_
        crashed = crash.amax(0)
        im = self.inv_m if dr is None else 1.0 / (self.mass * dr[0])
        dt = self.dt
        acx = (R02 * thrust + dx + cfx) * im
        acy = (R12 * thrust + dy + cfy) * im
        acz = (R22 * thrust + dz + gz + cfz) * im
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
            thrust, torch.maximum(done, crashed)]

    def _contacts(self, px, py, pz, R00, R01, R10, R11, R20, R21, spheres, cyl):
        """Each motor point's contact terms in the order they are summed
        (per motor: the ground's, each sphere's, each cylinder's), as
        (x, y, z) rows (the ground's x and y None), and the stacked crash
        flags."""
        rm, k = self.rm, self.spring
        mx = px + R00 * self.mx + R01 * self.my  # (M, N)
        my = py + R10 * self.mx + R11 * self.my
        mz = pz + R20 * self.mx + R21 * self.my
        pen = mz - rm
        per_motor = [[(None, None, (pen < 0).to(F) * (k * pen))]]
        crash = [(mz < 0).to(F)]
        for sx, sy, sz, sr, on in spheres:
            ex, ey, ez = mx - sx, my - sy, mz - sz
            dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
            sd = dist - sr
            inv = 1.0 / torch.clamp_min(dist, 1e-12)
            pen_s = sd - rm
            hit, mag = (pen_s < 0).to(F) * on, k * pen_s
            per_motor.append([(hit * mag * ex * inv, hit * mag * ey * inv,
                               hit * mag * ez * inv)])
            crash.append((sd < 0).to(F) * on)
        if cyl.shape[0]:
            cx, cy, cz, cr, ch, on = (c[:, None] for c in cyl.T)  # (C, 1) each
            mx3, my3, mz3 = mx[:, None], my[:, None], mz[:, None]  # (M, 1, N)
            ex, ey = mx3 - cx, my3 - cy
            r2d = torch.sqrt(ex * ex + ey * ey)
            d2d = r2d - cr
            z0, z1 = cz, cz + ch
            band = ((z0 < mz3) & (mz3 < z1)).to(F)
            dh = torch.minimum(torch.abs(mz3 - z0), torch.abs(mz3 - z1))
            d = band * d2d + (1 - band) * torch.sqrt(d2d * d2d + dh * dh)
            # the normal takes z relative to the base against the absolute band
            relz = mz3 - cz
            band_n = ((z0 < relz) & (relz < z1)).to(F)
            inv2d = 1.0 / torch.clamp_min(r2d, 1e-12)
            cap = torch.where(torch.abs(relz - z0) < torch.abs(relz - z1), -1.0, 1.0).to(F)
            pen_c = d - rm
            hit, mag = (pen_c < 0).to(F) * on, k * pen_c
            tx_ = hit * mag * (band_n * ex * inv2d)
            ty_ = hit * mag * (band_n * ey * inv2d)
            tz_ = hit * mag * ((1 - band_n) * cap)
            per_motor.append([(tx_[:, c], ty_[:, c], tz_[:, c]) for c in range(cyl.shape[0])])
            crash.append(((d < 0).to(F) * on).flatten(0, 1))
        terms = [tuple(None if x is None else x[m] for x in t) for m in range(mx.shape[0])
                 for group in per_motor for t in group]
        return terms, torch.cat([c.reshape(-1, c.shape[-1]) for c in crash])


class Megaloop:
    """The configuration's env around :class:`Quad`: the moving target, the
    reward, the rows, the ends and the resets."""

    def __init__(self, cfg: Dict, wld: Dict[str, torch.Tensor]):
        a = cfg["acro"]
        self.device = wld["sphere"].device
        self.quad = Quad(cfg["drone"], self.device)
        self.wld = wld
        self.K = cfg["num_steps"]
        self.action = [torch.full((1,), sim.f32(v), dtype=F, device=self.device)
                       for v in cfg["action"]]
        self.pos_low = [sim.f32(x) for x in a["pos_low"]]
        self.pos_span = [sim.f32(h - lo) for lo, h in zip(a["pos_low"], a["pos_high"])]
        self.vel_scale = sim.f32(a["vel_scale"])
        self.half_ypr = sim.f32(0.5 * sim.DEG2RAD * a["ypr_range_deg"])
        self.max_steps = sim.f32(a["max_episode_steps"])
        self.w = [sim.f32(a[k]) for k in ("w_progress", "w_alive", "w_crash", "w_rates")]
        self.randomize = bool(a["randomize"])
        self.scale_lo = [sim.f32(r[0]) for r in (a["mass_range"], a["drag_range"],
                                                 a["thrust_range"])]
        self.scale_span = [sim.f32(r[1] - r[0]) for r in (a["mass_range"], a["drag_range"],
                                                          a["thrust_range"])]
        self.wind = [sim.f32(w) for w in a["wind"]]
        self.wind_scale = sim.f32(a["wind_scale"])
        self.use_wind = any(w != 0.0 for w in a["wind"]) or a["wind_scale"] > 0.0
        self.gust = self.use_wind and a["wind_scale"] > 0.0
        self.two_pi = sim.f32(2.0 * math.pi)
        self.counters = torch.arange(17, dtype=torch.int64, device=self.device)[:, None]

    def targets(self, count0: torch.Tensor, i: int):
        """(cx, cy, cz) (S, B) of step ``i`` of B launches whose targets'
        path counters stood at ``count0`` (B,): each target on its circle."""
        p = self.wld["path"][:, :, None]
        cnt = count0 + float(i)
        res = torch.clamp_min(p[:, 4], 1.0)
        frac = cnt - torch.floor(cnt / res) * res
        theta = self.two_pi * frac / res
        return p[:, 0] + p[:, 3] * torch.cos(theta), p[:, 1] + p[:, 3] * torch.sin(theta), \
            p[:, 2].expand_as(theta)

    def draws(self, lane: torch.Tensor, i: int):
        """The reset values step ``i`` draws, before the target: the 10 pose
        rows (position, velocity, quaternion), the 3 scale rows and the 3
        wind rows. The 17 counters are hashed at once."""
        u = sim.uniform(lane, self.counters + (i + 1) * 32).unbind(0)

        def normals(a, b):  # sim.normals on two of the drawn rows
            r = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[a], sim.f32(1e-12))))
            t = sim.f32(sim.TWO_PI) * u[b]
            return r * torch.cos(t), r * torch.sin(t)

        pos = [self.pos_low[k] + u[k] * self.pos_span[k] for k in range(3)]
        z0, z1 = normals(3, 4)
        z2, _ = normals(5, 6)
        h = [(2.0 * u[7 + k] - 1.0) * self.half_ypr for k in range(3)]
        cr, sr, cp, sp, cy, sy = (torch.cos(h[0]), torch.sin(h[0]), torch.cos(h[1]),
                                  torch.sin(h[1]), torch.cos(h[2]), torch.sin(h[2]))
        pose = pos + [self.vel_scale * z0, self.vel_scale * z1, self.vel_scale * z2,
                      cy * cp * cr + sy * sp * sr, cy * cp * sr - sy * sp * cr,
                      cy * sp * cr + sy * cp * sr, sy * cp * cr - cy * sp * sr]
        ones = torch.ones_like(pos[0])
        scales = ([self.scale_lo[k] + u[10 + k] * self.scale_span[k] for k in range(3)]
                  if self.randomize else [ones] * 3)
        if self.gust:
            g0, g1 = normals(13, 14)
            g2, _ = normals(15, 16)
            wind = [self.wind[k] + self.wind_scale * g for k, g in enumerate((g0, g1, g2))]
        else:
            wind = [torch.full_like(ones, w) for w in self.wind]
        return pose, scales, wind

    def follow(self, starts: List[Tuple[torch.Tensor, int, int]]):
        """``self.K`` steps of B launches side by side, each given as (its
        input state (24, N), its targets' path counter, its kernel seed),
        with the configuration's action. Returns each launch's (state
        (24, N), reward sum (N,), reset flags (K, N))."""
        B, N = len(starts), starts[0][0].shape[1]
        dev = self.device
        s = list(torch.cat([c.to(F) for c, _, _ in starts], dim=1).unbind(0))
        lane = torch.cat([sim.lanes(N, seed, dev) for _, _, seed in starts])
        group = torch.arange(B, device=dev).repeat_interleave(N)
        c0 = torch.tensor([float(c) for _, c, _ in starts], dtype=F, device=dev)
        sph = self.wld["sphere"]
        wp, wa, wc, wr = self.w
        a0, a1, a2, _ = self.action
        rates_pen = a0 * a0 + a1 * a1 + a2 * a2
        rsum = torch.zeros(B * N, dtype=F, device=dev)
        flags = torch.zeros((self.K, B * N), dtype=F, device=dev)
        for i in range(self.K):
            cx, cy, cz = (c[:, group] for c in self.targets(c0, i))  # (S, B N)
            spheres = list(zip(cx, cy, cz, sph[:, 3], sph[:, 4]))
            dr = s[18:21] if self.randomize else None
            wind = s[21:24] if self.use_wind else None
            phys = self.quad.step(s[:15], self.action, spheres, self.wld["cyl"], dr, wind)
            crashed = phys[14]
            tx, ty, tz = cx[0], cy[0], cz[0]  # the chased target
            ex, ey, ez = phys[0] - tx, phys[1] - ty, phys[2] - tz
            dist = torch.sqrt(ex * ex + ey * ey + ez * ez)
            reward = wp * (s[16] - dist) + wa - wc * crashed - wr * rates_pen
            t = s[15] + 1.0
            end = torch.maximum(crashed, (t >= self.max_steps).to(F))
            pose, scales, wnd = self.draws(lane, i)
            rx, ry, rz = pose[0] - tx, pose[1] - ty, pose[2] - tz
            zero = torch.zeros_like(dist)
            live = phys[:14] + [zero, t, dist, s[17] + reward] + s[18:24]
            reset = pose + [zero] * 6 + [torch.sqrt(rx * rx + ry * ry + rz * rz), zero] \
                + scales + wnd
            sel = end > 0.5
            s = list(torch.where(sel, torch.stack(reset), torch.stack(live)).unbind(0))
            rsum = rsum + reward
            flags[i] = sel.to(F)
        return list(zip(torch.stack(s).split(N, dim=1), rsum.split(N), flags.split(N, dim=1)))


def check_megaloop(cfg: Dict, seed: int, launches: List[MegaLaunch],
                   per_launch: Optional[List[Dict]] = None) -> Dict[str, float]:
    """The cell's numbers over the recorded launches, each the widest
    |program - reference| / (1 + |reference|): ``start`` (the first
    launch's input state against the bank drawn from ``seed``), ``state``
    (the 24 rows after each launch) and ``reward`` (each env's reward sum).
    Each launch's ``done`` is set to the reference's reset flags;
    ``per_launch`` (optional) gets each launch's numbers (the start goes
    with the first)."""
    device = launches[0].cols.device
    wld = world(cfg, seed, device)
    env = Megaloop(cfg, wld)
    res = int(cfg["world"]["targets"]["path"]["resolution"])
    rows = [{"start": relgap(launches[0].cols, start(cfg, seed, wld))}] + [
        {} for _ in launches[1:]]
    followed = env.follow([(L.cols, (L.call * env.K) % res, L.seed) for L in launches])
    for row, L, (state, rsum, flags) in zip(rows, launches, followed):
        L.done = flags
        row.update(state=relgap(L.cols_out, state), reward=relgap(L.reward, rsum))
    if per_launch is not None:
        per_launch.extend(rows)
    out: Dict[str, float] = {}
    for row in rows:
        for k, v in row.items():
            if k not in out or not (v <= out[k]):
                out[k] = v
    return out
