"""Float64 NumPy oracle of the reference FpyV drone step (see package doc);
the port's own copy of ``tools/oracle/sim.py``, on the port's config and
thrust tables."""

from __future__ import annotations

import numpy as np

from fpyv_tpu_torch.config import FpyvConfig
from fpyv_tpu_torch.physics.motor import F80_BENCH_TABLES, _F80_THROTTLE

AIR_DENSITY = 1.2225


# --- rotation helpers (reference helper_functions.py semantics) -------------


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def euler_to_R(roll, pitch, yaw):
    """R = Rz @ Ry @ Rx (helper_functions.py:39-44)."""
    return rot_z(yaw) @ rot_y(pitch) @ rot_x(roll)


def R_to_euler(R):
    """Generic branch of helper_functions.py:47-62 (the other branch is dead)."""
    x = np.arctan2(R[2, 1], R[2, 2])
    y = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    z = np.arctan2(R[1, 0], R[0, 0])
    return np.array([x, y, z])


def rotate_body_by_rates(R, rates_deg, dt):
    """kinematics.py:27-30: (E(deg2rad(rates)·dt) @ R.T).T"""
    rates_dt = np.deg2rad(np.asarray(rates_deg, np.float64)) * dt
    return (euler_to_R(*rates_dt) @ R.T).T


# --- world objects ----------------------------------------------------------


class OracleGround:
    collides = True

    def distance(self, p):
        return p[2]  # components.py:674-677 with n=[0,0,1], d=0

    def normal(self, p):
        return np.array([0.0, 0.0, 1.0])


class OracleTarget:
    """Icosphere target, optional circular path (components.py:753-777)."""

    collides = True

    def __init__(self, position, radius, path=None):
        self.position = np.asarray(position, np.float64)
        self.radius = float(radius)
        self.path_center = self.position.copy()
        self.path = path  # dict(radius=..., resolution=...) or None
        self.count = 0

    def update(self):
        if self.path is None:
            return
        res = int(self.path["resolution"])
        r = float(self.path["radius"])
        theta = 2.0 * np.pi * (self.count % res) / res
        self.position = self.path_center + np.array(
            [np.cos(theta) * r, np.sin(theta) * r, 0.0]
        )
        self.count += 1

    def distance(self, p):
        return np.linalg.norm(p - self.position) - self.radius

    def normal(self, p):
        d = p - self.position
        return d / np.linalg.norm(d)


class OracleCylinder:
    """components.py:685-729 with both quirks (positive inside-sqrt; the
    normal's relative-z band check)."""

    collides = True

    def __init__(self, position, radius, height):
        self.position = np.asarray(position, np.float64)
        self.radius = float(radius)
        self.height = float(height)

    def distance(self, p):
        d2d = np.linalg.norm(p[:2] - self.position[:2]) - self.radius
        if self.position[2] < p[2] < self.position[2] + self.height:
            return d2d
        dh = min(
            abs(p[2] - self.position[2]),
            abs(p[2] - (self.position[2] + self.height)),
        )
        return np.sqrt(d2d**2 + dh**2)

    def normal(self, p):
        q = p - self.position  # components.py:719 — band checked on relative z
        if self.position[2] < q[2] < self.position[2] + self.height:
            n = np.array([q[0], q[1], 0.0])
            return n / np.linalg.norm(n)
        if abs(q[2] - self.position[2]) < abs(q[2] - (self.position[2] + self.height)):
            return np.array([0.0, 0.0, -1.0])
        return np.array([0.0, 0.0, 1.0])


class OracleGate:
    """components.py:784-822 — plane distance only; excluded from collisions."""

    collides = False

    def __init__(self, position, rotation_matrix, size):
        self.position = np.asarray(position, np.float64)
        self.rotation_matrix = np.asarray(rotation_matrix, np.float64)
        self.size = float(size)

    @property
    def normal_vec(self):
        return self.rotation_matrix[:, 0]

    def distance(self, p):
        n = self.normal_vec
        return np.dot(n, p) - np.dot(n, self.position)


# --- PID (components.py:15-54) ---------------------------------------------


class OraclePid:
    def __init__(self, kP, kI, kD, dt, integral_clip=1.0, min_output=0.3,
                 max_output=1.0, derivative_transition_rate=0.5):
        self.kP, self.kI, self.kD, self.dt = kP, kI, kD, dt
        self.integral_clip = integral_clip
        self.min_output, self.max_output = min_output, max_output
        self.dtr = derivative_transition_rate
        self.reset()

    def reset(self):
        self.error = 0.0
        self.integral = 0.0
        self.derivative = 0.0
        self.prev_derivative = 0.0
        self.previous_error = 0.0
        self.is_first = True

    def __call__(self, current, target):
        self.error = current - target
        self.integral = np.clip(
            0.99 * self.integral + self.error * self.dt,
            -self.integral_clip, self.integral_clip,
        )
        d = np.clip(
            (1 - self.is_first) * (self.error - self.previous_error) / self.dt, -1, 1
        )
        self.derivative = (1 - self.dtr) * self.prev_derivative + self.dtr * d
        self.prev_derivative = self.derivative
        self.is_first = False
        self.previous_error = self.error
        return np.clip(
            self.kP * self.error + self.kI * self.integral + self.kD * self.derivative,
            self.min_output, self.max_output,
        )


# --- camera (components.py:449-629) ----------------------------------------

WORLD2CAM = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


class OracleCamera:
    def __init__(self, pitch_deg, rel_position, fov_deg, resolution):
        self.resolution = np.asarray(resolution)
        self.rel_position = np.asarray(rel_position, np.float64)
        self.rel_R = WORLD2CAM.T @ euler_to_R(np.deg2rad(pitch_deg), 0.0, 0.0)
        self.focal_length = self.resolution[0] / (2 * np.tan(np.deg2rad(fov_deg) / 2))
        self.K = np.array(
            [
                [self.focal_length, 0.0, self.resolution[0] / 2],
                [0.0, self.focal_length, self.resolution[1] / 2],
                [0.0, 0.0, 1.0],
            ]
        )
        self.position = None
        self.R = None

    def update(self, drone_pos, drone_R):
        self.position = drone_pos + drone_R @ self.rel_position
        self.R = drone_R @ self.rel_R

    def projection_matrix(self):
        ext = np.vstack(
            [np.hstack([self.R, self.position.reshape(-1, 1)]), [0, 0, 0, 1]]
        )
        return self.K @ np.linalg.inv(ext)[:3, :]

    def project_points(self, pts):
        """pts (N,3) -> pixel ints (M,2), depth (M,) for depth>0."""
        P = self.projection_matrix()
        h = P @ np.vstack([pts.T, np.ones(len(pts))])
        h = h.T
        depth = h[:, 2]
        keep = depth > 0
        h, depth = h[keep], depth[keep]
        px = (h[:, :2] / depth.reshape(-1, 1)).astype(int)
        return px, depth

    def pixel2direction(self, pixel):
        ph = np.append(np.asarray(pixel, np.float64), 1.0)
        d = self.R @ np.linalg.inv(self.K) @ ph
        return d / np.linalg.norm(d)

    @staticmethod
    def bbox_corners(points):
        """AABB corners in the reference ordering (helper_functions.py:120-136)."""
        mn, mx = points.min(axis=0), points.max(axis=0)
        box = np.zeros((8, 3))
        box[:4, 0] = mn[0]
        box[4:, 0] = mx[0]
        box[::2, 1] = mn[1]
        box[1::2, 1] = mx[1]
        box[[0, 1, 4, 5], 2] = mn[2]
        box[[2, 3, 6, 7], 2] = mx[2]
        return box

    def prune(self, point_sets):
        """components.py:585-600: keep sets whose projected bbox has any
        corner in front AND all(max_p > 0) and all(min_p < resolution)."""
        kept = []
        for pts in point_sets:
            px, depth = self.project_points(self.bbox_corners(pts))
            if len(px) == 0:
                continue
            min_p, max_p = px.min(axis=0), px.max(axis=0)
            if np.all(max_p > 0) and np.all(min_p < self.resolution):
                kept.append(pts)
        return kept

    def render_depth_image(self, point_sets, max_depth=10.0, prune=True):
        """Nearest-z point splat (components.py:614-629) over raw point arrays."""
        W, H = int(self.resolution[0]), int(self.resolution[1])
        img = np.zeros((H, W))
        if prune:
            point_sets = self.prune(point_sets)
        pts = np.vstack(point_sets) if point_sets else np.zeros((0, 3))
        if len(pts):
            px, depth = self.project_points(pts)
            for z, (u, v) in zip(depth, px):
                if 0 <= u < W and 0 <= v < H and (img[v, u] == 0 or img[v, u] > z):
                    img[v, u] = z
        np.clip(img, 0, max_depth, out=img)
        img[img == 0] = max_depth
        return (255 * (1 - img / max_depth)).astype(np.uint8)


# --- the drone --------------------------------------------------------------


class OracleDrone:
    """Single-drone float64 oracle of Drone.__init__/reset/step."""

    def __init__(self, cfg: FpyvConfig):
        self.cfg = cfg
        d, s = cfg.drone, cfg.simulator
        self.dt = s.dt
        self.gravity = s.gravity
        self.mass = d.mass / 1000.0
        self.max_rates = float(d.max_rates)
        self.drag_coef = np.asarray(d.drag_coefficients, np.float64)
        dims = np.asarray(d.dimensions, np.float64) / 100.0
        self.cross_sections = np.array(
            [dims[1] * dims[2], dims[0] * dims[2], dims[0] * dims[1]]
        )
        self.rates_tr = d.rates_transition_rate
        self.thrust_tr = d.thrust_transition_rate
        # motors (components.py:120-125)
        self.n_motors = 4
        self.motor_radius = 0.1
        r = 5 * 2.54 / 100
        t = np.linspace(0, 2 * np.pi, self.n_motors + 1)[:-1]
        t = t + (t[1] - t[0]) / 2
        self.motors_rel = r * np.stack([np.cos(t), np.sin(t), np.zeros(4)], axis=-1)
        # thrust polynomials (components.py:128-144)
        thrust_g = F80_BENCH_TABLES[d.motor_test_report_idx][2]
        throttle = _F80_THROTTLE
        thrust_n = self.n_motors * thrust_g / 1000.0 * self.gravity
        self._fwd = np.polyfit(np.append(0.0, throttle), np.append(0.0, thrust_n), 3)
        self._inv = np.polyfit(np.append(0.0, thrust_n), np.append(0.0, throttle), 3)
        self.min_force = float(np.polyval(self._fwd, 5.0))
        self.max_force = float(np.polyval(self._fwd, 100.0))
        self.camera = OracleCamera(
            cfg.camera.camera_angle,
            cfg.camera.position_relative_to_frame,
            cfg.camera.fov,
            cfg.camera.resolution,
        )
        pid = d.force_multiplier_pid
        self.force_multiplier_pid = OraclePid(
            kP=pid.kP, kI=pid.kI, kD=pid.kD, dt=self.dt,
            integral_clip=pid.integral_clip,
            min_output=self.min_force, max_output=self.max_force,  # :143-144
            derivative_transition_rate=pid.derivative_transition_rate,
        )

    def throttle2thrust(self, x):
        return np.polyval(self._fwd, 100.0 * (x + 1.0) / 2.0)

    def thrust2throttle(self, f):
        return np.clip(np.polyval(self._inv, f) / 100.0 * 2.0 - 1.0, -1.0, 1.0)

    def reset(self, position, velocity, ypr_deg):
        self.pos = np.asarray(position, np.float64).copy()
        self.vel = np.asarray(velocity, np.float64).copy()
        self.R = euler_to_R(*np.deg2rad(np.asarray(ypr_deg, np.float64)))
        self.rates = np.zeros(3)
        self.prev_thrust = 0.0
        self.accel = np.zeros(3)
        self.done = False
        self.camera.update(self.pos, self.R)
        self.force_multiplier_pid.reset()
        self.pns_prev_pixel = None
        self.pixel_velocity = np.zeros(2)

    def _drag(self, R, vel, wind):
        vsum = vel + wind
        f_body = (
            -0.5 * self.drag_coef * AIR_DENSITY * self.cross_sections
            * (R.T @ vsum) * np.linalg.norm(vsum)
        )
        return R @ f_body

    def step(self, action, wind, objects, R_override=None, thrust_override=None):
        """components.py:220-248, exact order."""
        action = np.asarray(action, np.float64)
        # action2force (:179-196)
        rates_cmd = np.clip(-action[:3] * self.max_rates, -self.max_rates, self.max_rates)
        self.rates = rates_cmd * self.rates_tr + self.rates * (1 - self.rates_tr)
        thrust_scalar = (
            self.throttle2thrust(action[3]) * self.thrust_tr
            + self.prev_thrust * (1 - self.thrust_tr)
        )
        self.prev_thrust = thrust_scalar
        if R_override is not None:  # :230-232
            self.R = np.asarray(R_override, np.float64)
            thrust_scalar_applied = float(thrust_override)
        else:
            thrust_scalar_applied = thrust_scalar
        thrust_vec = self.R[:, 2] * thrust_scalar_applied

        drag = self._drag(self.R, self.vel, wind)
        gravity = np.array([0.0, 0.0, -self.gravity * self.mass])
        motors_world = self.motors_rel @ self.R.T  # :235
        motor_pts = self.pos + motors_world

        # handle_collisions (:198-214): k=100, c=0
        contact = np.zeros(3)
        crashed = False
        for obj in objects:
            if not obj.collides:
                continue
            d = np.array([obj.distance(p) for p in motor_pts])
            n = np.array([obj.normal(p) for p in motor_pts])
            if np.any(d < 0):
                crashed = True
                break
            pen = d - self.motor_radius < 0
            for i in range(self.n_motors):
                if pen[i]:
                    contact += (-100.0 * (d[i] - self.motor_radius) - 0.0) * n[i]
        if np.any(motor_pts[:, 2] < 0.0):  # :239-240
            crashed = True
        self.done = self.done or crashed

        total = thrust_vec + gravity + drag + contact
        self.accel = total / self.mass

        # update (:216-218) — position first, double rotation
        self.pos = self.pos + self.vel * self.dt
        self.vel = self.vel + self.accel * self.dt
        self.R = rotate_body_by_rates(self.R, self.rates, self.dt)
        self.R = rotate_body_by_rates(self.R, self.rates, self.dt)

        self.camera.update(self.pos, self.R)
        gyro = euler_to_R(*self.rates)  # deg/s-as-radians quirk (:247)
        return self.R.T, gyro, self.R @ self.accel

    def point_and_shoot(self, pixel, action, mode="level", max_iters=None):
        """components.py:312-381, ref_frame='world'. `max_iters` caps the
        force-saturation loop (None = loop to convergence like the
        reference's `while`; pass 4 to mirror the vectorised guidance's fixed count)."""
        cfg = self.cfg
        pns = cfg.point_and_shoot
        res = np.asarray(cfg.camera.resolution, np.float64)
        pixel = np.asarray(pixel, np.float64) + np.asarray(action[2:4]) * res / 2.0
        if self.pns_prev_pixel is None:
            self.pns_prev_pixel = pixel
            self.pixel_velocity = np.zeros(2)
        else:
            self.pixel_velocity = (pixel - self.pns_prev_pixel) / self.dt
            self.pns_prev_pixel = pixel
        dir2target = self.camera.pixel2direction(pixel)
        gravity = np.array([0.0, 0.0, -9.81 * self.mass])
        vnorm = np.linalg.norm(self.vel)
        vdot = (self.vel / vnorm) @ dir2target
        vdrag = pns.virtual_drag_coefficient * (-(vdot - 1.0) / 2.0 * -self.vel * vnorm)
        tof = pns.tof_effective_distance
        vlift = ((self.pos[2] < tof) * -(tof - self.pos[2])
                 * pns.virtual_lift_coefficient * gravity
                 * -(np.clip(self.vel[2], a_min=-np.inf, a_max=0.0)))  # :345
        screen_pos = (res / 2.0 * (1.0 + np.asarray(action[:2]))).astype(int)
        mult = self.force_multiplier_pid(pixel[1], screen_pos[1])  # :350
        force = mult * dir2target + vdrag + vlift - gravity
        fnorm = np.linalg.norm(force)
        criteria = 0.9999  # :356
        iters = 0
        while fnorm > self.max_force and (max_iters is None or iters < max_iters):
            mult = np.clip(mult * criteria, self.force_multiplier_pid.min_output,
                           self.force_multiplier_pid.max_output)
            force = mult * dir2target + vdrag + vlift - gravity
            fnorm = np.linalg.norm(force)
            criteria = self.max_force / fnorm  # :362
            iters += 1
        second = gravity if mode == "level" else dir2target
        y = np.cross(force, second)
        x = np.cross(y, force)
        R = np.stack([x, y, force], axis=1)
        R = R / np.linalg.norm(R, axis=0)
        return R, fnorm

    def calculate_needed_force_orientation(self, pixel, target_distance,
                                           mode="level"):
        """components.py:258-304, ref_frame='world'. `target_distance` is the
        target SDF distance at the drone position (pre-UWB clamp)."""
        cfg = self.cfg
        pns = cfg.point_and_shoot
        dir2target = self.camera.pixel2direction(pixel)
        gravity = np.array([0.0, 0.0, -9.81 * self.mass])  # :270 pins g=9.81
        vnorm = np.linalg.norm(self.vel)
        vdot = (self.vel / vnorm) @ dir2target
        virtual_drag = -(vdot - 1.0) / 2.0 * -self.vel * vnorm  # :272
        vdrag_f = pns.virtual_drag_coefficient * virtual_drag
        tof = pns.tof_effective_distance
        vlift = ((self.pos[2] < tof) * -(tof - self.pos[2])
                 * pns.virtual_lift_coefficient * gravity
                 * (1.0 + abs(self.vel[2])))  # :286
        measured = min(target_distance, cfg.drone.UWB_sensor_max_range)  # :287
        mult = self.force_multiplier_pid(measured, cfg.drone.keep_distance)
        mult = np.clip(mult, self.force_multiplier_pid.min_output,
                       self.force_multiplier_pid.max_output)  # :290
        force = mult * dir2target + vdrag_f + vlift - gravity  # :292
        force_norm = np.linalg.norm(force)
        second = gravity if mode == "level" else dir2target  # :294-299
        y = np.cross(force, second)
        x = np.cross(y, force)
        R = np.stack([x, y, force], axis=1)  # :302
        R = R / np.linalg.norm(R, axis=0)  # :303
        return R, force_norm


# --- rates controller (tests/rotation_pid.py:100-139) -----------------------


class OracleRatesController:
    def __init__(self, gain, max_rates, state_tc, goal_tc, error_tc):
        self.gain = gain * np.ones(3)
        self.max_rates = max_rates
        self.state_tc, self.goal_tc, self.error_tc = state_tc, goal_tc, error_tc
        self.reset()

    def reset(self):
        self.prev_state = np.zeros(3)
        self.prev_goal = np.zeros(3)
        self.prev_error = np.zeros(3)

    def get_rates(self, R_current, R_goal):
        es = self.state_tc * R_to_euler(R_current) + (1 - self.state_tc) * self.prev_state
        self.prev_state = es
        R_c = euler_to_R(*es)
        eg = self.goal_tc * R_to_euler(R_goal) + (1 - self.goal_tc) * self.prev_goal
        self.prev_goal = eg
        R_g = euler_to_R(*eg)
        R_rel = R_g.T @ R_c
        ee = self.error_tc * R_to_euler(R_rel) + (1 - self.error_tc) * self.prev_error
        self.prev_error = ee
        return np.clip(self.gain * np.rad2deg(ee), -self.max_rates, self.max_rates)
