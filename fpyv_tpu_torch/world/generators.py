"""World generators: tracks, targets, cylinders, ground — reference parity
(mirrors ``fpyv_tpu.world.generators``; with the same numpy seed the
world comes out identical).

Host-side builders (numpy + seeded rng) producing the SoA ``World`` the
physics consumes and the raw point clouds the renderer consumes.

Reference parity (src/utils/generators.py + components.py constructors),
including two deliberate reference quirks preserved bug-for-bug:

- ``generate_track`` places gate x-coordinates with ``cos(θ)·gate_size`` but
  y with ``sin(θ)·radius`` (generators.py:9 — an ellipse unless they match),
  and passes ``gate_resolution`` as the SIZE of rectangle/half-circle gates
  (generators.py:17); only circle gates get ``gate_size/2``.
- Ground's random point cloud scales z by 0.2/size of the x/y extent
  (components.py:655-660).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fpyv_tpu_torch.config import SimulatorConfig
from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.ops.rotations import quat_to_rotmat
from fpyv_tpu_torch.physics.world import GATE_SHAPES, empty_world


def euler_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


# ---------------------------------------------------------------------------
# Point-cloud constructors (components.py per-class generate_points parity)
# ---------------------------------------------------------------------------


def ground_points(size: float, resolution: int, random: bool = False,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Ground cloud (components.py:655-664)."""
    if random:
        rng = rng or np.random.default_rng()
        pts = size * (2.0 * rng.random((resolution**2, 3)) - 1.0)
        pts[:, 2] /= size
        pts[:, 2] *= 0.2
        return pts
    axis = np.linspace(-size / 2, size / 2, resolution)
    x, y = np.meshgrid(axis, axis)
    return np.stack([x.reshape(-1), y.reshape(-1), np.zeros(x.size)], axis=-1)


def cylinder_points(radius: float, height: float, angle_resolution: int,
                    height_resolution: int, random: bool = False,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Cylinder surface cloud relative to its base center (components.py:697-708)."""
    if random:
        rng = rng or np.random.default_rng()
        angles = rng.random((height_resolution, angle_resolution)) * 2 * np.pi
        heights = rng.random((height_resolution, angle_resolution)) * height
    else:
        angles = np.linspace(0, 2 * np.pi, angle_resolution)
        heights = np.linspace(0, height, height_resolution)
        angles, heights = np.meshgrid(angles, heights)
    return np.stack(
        [radius * np.cos(angles).reshape(-1),
         radius * np.sin(angles).reshape(-1),
         heights.reshape(-1)], axis=-1,
    )


def gate_corners(size: float, shape: str = "rectangle",
                 resolution: int = 17) -> np.ndarray:
    """Gate polyline in the gate frame, closed (components.py:790-805)."""
    if shape == "rectangle":
        corners = np.array(
            [[0, -1, -1], [0, 1, -1], [0, 1, 1], [0, -1, 1]], dtype=np.float64
        ) * size / 2
    elif "circle" in shape:
        coef = 1 if "half" in shape else 2
        theta = np.linspace(0, coef * np.pi, resolution)
        y = np.cos(theta) * size / coef
        z = np.sin(theta) * size / coef
        corners = np.stack([np.zeros_like(y), y, z], axis=-1)
        if "half" in shape:
            corners = corners - np.array([0, 0, size / 2])
    else:
        raise NotImplementedError(shape)
    return np.vstack([corners, corners[:1]])


# ---------------------------------------------------------------------------
# Object-list generators (generators.py parity)
# ---------------------------------------------------------------------------


@dataclass
class TargetSpec:
    position: np.ndarray
    radius: float
    nu: int
    path: Optional[Dict[str, Any]]  # {"radius":..., "resolution":...} or None


@dataclass
class CylinderSpec:
    position: np.ndarray
    radius: float
    height: float
    angle_resolution: int
    height_resolution: int
    random: bool


@dataclass
class GateSpec:
    position: np.ndarray
    rotmat: np.ndarray
    size: float
    shape: str
    resolution: int


def generate_targets(count: int, center, std: float, size: float,
                     variation: float, nu: int, path,
                     rng: np.random.Generator) -> List[TargetSpec]:
    """generators.py:21-24."""
    return [
        TargetSpec(
            position=np.asarray(center, np.float64) + std * rng.standard_normal(3),
            radius=float(abs(size + variation * rng.standard_normal())),
            nu=nu,
            path=dict(path) if path else None,
        )
        for _ in range(count)
    ]


def generate_cylinders(count: int, center, center_std, radius: float,
                       radius_std: float, height: float, height_std: float,
                       angle_resolution: int, height_resolution: int,
                       random: bool, rng: np.random.Generator) -> List[CylinderSpec]:
    """generators.py:27-36."""
    return [
        CylinderSpec(
            position=np.asarray(center, np.float64)
            + np.asarray(center_std, np.float64) * rng.standard_normal(3),
            radius=float(abs(radius + radius_std * rng.standard_normal())),
            height=float(abs(height + height_std * rng.standard_normal())),
            angle_resolution=angle_resolution,
            height_resolution=height_resolution,
            random=random,
        )
        for _ in range(count)
    ]


def generate_track(count: int, radius: float, gate_size: float,
                   gate_resolution: int) -> List[GateSpec]:
    """generators.py:7-18 with both quirks preserved (module docstring)."""
    theta = np.linspace(0, 2 * np.pi, count + 1)[:-1]
    positions = np.stack(
        [np.cos(theta) * gate_size,  # quirk: gate_size, not radius
         np.sin(theta) * radius,
         np.zeros_like(theta)], axis=-1,
    )
    shapes = ["rectangle", "circle", "half_circle"]
    gates = []
    for i, p in enumerate(positions):
        shape = shapes[i % 3]
        rotmat = euler_z(theta[i] + np.pi / 2)
        if shape == "circle":
            gates.append(GateSpec(p + np.array([0, 0, gate_size / 2]), rotmat,
                                  gate_size / 2, shape, gate_resolution))
        else:
            # quirk: size = gate_resolution for rectangle/half_circle
            gates.append(GateSpec(p.copy(), rotmat, float(gate_resolution),
                                  shape, gate_resolution))
    return gates


# ---------------------------------------------------------------------------
# Full world builder
# ---------------------------------------------------------------------------


@dataclass
class WorldSpec:
    """Host-side object lists (the analog of simulator.py:54-58's world)."""

    targets: List[TargetSpec] = field(default_factory=list)
    cylinders: List[CylinderSpec] = field(default_factory=list)
    gates: List[GateSpec] = field(default_factory=list)
    ground: Optional[Dict[str, Any]] = None  # {"size","resolution","random"}

    @classmethod
    def from_config(cls, sim: SimulatorConfig, seed: int = 0) -> "WorldSpec":
        rng = np.random.default_rng(seed)
        t = dict(sim.targets)
        path = t.pop("path", None)
        return cls(
            targets=generate_targets(**t, path=path, rng=rng),
            cylinders=generate_cylinders(**sim.obstacles, rng=rng),
            gates=generate_track(**sim.track),
            ground=dict(sim.ground),
        )


def build_world(spec: WorldSpec, dtype=torch.float32, device=None):
    """WorldSpec -> physics SoA World on ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    S, C, G = len(spec.targets), len(spec.cylinders), len(spec.gates)
    w = empty_world(S, C, G, ground=spec.ground is not None, dtype=dtype, device=device)

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=device)

    if S:
        w = w.replace(
            sphere_center=t([s.position for s in spec.targets]),
            sphere_radius=t([s.radius for s in spec.targets]),
            sphere_path_center=t([s.position for s in spec.targets]),
            sphere_path_radius=t([s.path["radius"] if s.path else 0.0 for s in spec.targets]),
            sphere_path_res=t([s.path["resolution"] if s.path else 1 for s in spec.targets],
                              torch.int32),
            sphere_has_path=t([s.path is not None for s in spec.targets], torch.bool),
        )
    if C:
        w = w.replace(
            cyl_center=t([c.position for c in spec.cylinders]),
            cyl_radius=t([c.radius for c in spec.cylinders]),
            cyl_height=t([c.height for c in spec.cylinders]),
        )
    if G:
        w = w.replace(
            gate_pos=t([g.position for g in spec.gates]),
            gate_rotmat=t([g.rotmat for g in spec.gates]),
            gate_size=t([g.size for g in spec.gates]),
            gate_shape=t([GATE_SHAPES.index(g.shape) for g in spec.gates], torch.int32),
        )
    return w


# ---------------------------------------------------------------------------
# A contact-dense start, for the fused kernels' checks: the contact forces
# are sums over motor points and primitives, so a start with several motor
# points on a sphere and a cylinder in one step tests the order of the sums
# ---------------------------------------------------------------------------

CONTACT_SPHERES = np.array([[0.0, 0.0, 3.0], [0.0, 2.25, 3.0]], np.float32)  # radius 1 each
CONTACT_CYLINDERS = np.array([  # base centre xyz, radius, height, active
    [2.15, 0.0, 0.0, 1.0, 10.0, 1], [0.0, -2.15, 0.0, 1.0, 10.0, 1],
    [-2.2, 0.0, 2.5, 1.0, 1.0, 1], [1.2, 1.9, 0.0, 0.4, 10.0, 1],
    [8.0, 8.0, 0.0, 0.5, 5.0, 1], [-8.0, 8.0, 0.0, 0.5, 5.0, 1],
    [8.0, -8.0, 0.0, 0.5, 5.0, 1], [2.15, 0.0, 0.0, 1.0, 10.0, 0]], np.float32)
# drone centres in the gaps: sphere 0 and cylinder 0 (0.15 m apart), sphere 0
# and cylinder 1, the two spheres (0.25 m), sphere 0 and the cap of cylinder 2
CONTACT_SITES = np.array([[1.075, 0.0, 3.0], [0.0, -1.075, 3.0], [0.0, 1.125, 3.0],
                          [-1.1, 0.0, 3.45]], np.float32)


def contact_world(dtype=torch.float32, device=None):
    """Two unit spheres and eight cylinders (the last inactive, on top of the
    first) that stand 0.15-0.25 m apart, less than a motor span, with
    ground; no target path."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)

    c = CONTACT_CYLINDERS
    return empty_world(n_spheres=2, n_cylinders=8, dtype=dtype, device="cpu").replace(
        sphere_center=t(CONTACT_SPHERES), sphere_radius=t(np.ones(2)), cyl_center=t(c[:, :3]),
        cyl_radius=t(c[:, 3]), cyl_height=t(c[:, 4]), cyl_active=torch.as_tensor(c[:, 5] > 0),
    ).to(resolve_device(device))


def contact_start(n: int, seed: int):
    """Drone centres, velocities and Euler angles (degrees) at the gaps of
    :func:`contact_world`, env e at gap e % 4, jittered by up to 2 cm, 0.3
    m/s and 15 degrees from a numpy seed: most put motor points on a sphere
    and a cylinder in the same step. Three (n, 3) float32 arrays."""
    rng = np.random.default_rng(seed)
    pos = CONTACT_SITES[np.arange(n) % len(CONTACT_SITES)] + rng.uniform(-0.02, 0.02, (n, 3))
    vel = rng.uniform(-0.3, 0.3, (n, 3))
    ypr = rng.uniform(-15.0, 15.0, (n, 3))
    return pos.astype(np.float32), vel.astype(np.float32), ypr.astype(np.float32)


# ---------------------------------------------------------------------------
# Render edge cases, for the policy rollouts' checks (K7, K8): worlds and
# camera poses where a primitive cannot hit (inactive, behind the camera, a
# plane through the camera), where the camera sits inside a sphere or an
# open tube, and where the rays run along a tube's axis
# ---------------------------------------------------------------------------

EDGE_CASES = ("inside_sphere", "inactive", "cylinder_band", "down_axis", "gate_edge_behind",
              "on_ground", "gate_shapes", "open_view")
RACE_EDGE_CASES = ("inside_obstacle", "obstacle_arrives", "gate_edge_on", "gate_behind")


def _facing(normal) -> np.ndarray:
    """A gate rotation whose first column (the gate's normal) is ``normal``."""
    n = np.asarray(normal, np.float64) / np.linalg.norm(normal)
    up = np.array([0.0, 0.0, 1.0]) if abs(n[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    ey = np.cross(up, n)
    ey /= np.linalg.norm(ey)
    return np.stack([n, ey, np.cross(n, ey)], axis=1)


def render_edge_bank(n: int, rig, dtype=torch.float32, device=None):
    """A batched world of ``n`` envs (2 spheres, 2 cylinders, 2 gates,
    ground) and each env's drone position (n, 3) and quaternion (n, 4)
    (float32 numpy), env e being :data:`EDGE_CASES` [e % 8] for the camera
    of ``rig``:

    0. the camera inside sphere 0 (the target);
    1. an inactive sphere and an inactive cylinder in view;
    2. a cylinder whose height band holds the camera, and an open tube
       around the camera;
    3. the camera looking straight down two coaxial tubes, above their tops;
    4. a gate edge-on to the camera (its plane holds the camera exactly, so
       its ndot0 is 0) and a ring behind the camera, facing it;
    5. the camera on the ground plane (z = 0 exactly: no ray meets it);
    6. a ring and a half-circle gate in view;
    7. an open view of a gate, a cylinder and the spheres.

    Sphere 0 stays active (the reward's target) and in view but in case 0."""
    mount = np.asarray(rig.mount_rotation, np.float64)
    rel = np.asarray(rig.rel_position, np.float64)
    view = mount[:, 2]  # the optical axis at a level body
    fwd = np.array([1.0, 0.0, 0.0])
    sc, sr, sa = np.zeros((n, 2, 3)), np.ones((n, 2)), np.zeros((n, 2), bool)
    cc, cr = np.zeros((n, 2, 3)), np.full((n, 2), 0.5)
    ch, ca = np.ones((n, 2)), np.zeros((n, 2), bool)
    gp, gR = np.zeros((n, 2, 3)), np.tile(np.eye(3), (n, 2, 1, 1))
    gs, ga, gsh = np.full((n, 2), 2.0), np.zeros((n, 2), bool), np.zeros((n, 2), np.int32)
    pos, quat = np.zeros((n, 3)), np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))
    for e in range(n):
        case = EDGE_CASES[e % len(EDGE_CASES)]
        p = np.array([0.0, 0.0, 0.0 if case == "on_ground" else 2.0])
        if case == "down_axis":  # 125 degrees about y: the 35-degree uptilt points down
            half = np.deg2rad(125.0) / 2
            quat[e] = [np.cos(half), 0.0, np.sin(half), 0.0]
            p = np.array([0.0, 0.0, 3.0])
        pos[e] = p
        c = p + quat_to_rotmat(torch.as_tensor(quat[e])).numpy() @ rel  # the camera
        sc[e, 0], sr[e, 0], sa[e, 0] = c + 7 * fwd + [0.0, 1.5, 0.0], 1.0, True
        if case == "inside_sphere":
            sc[e, 0], sr[e, 0] = c, 1.5
            sc[e, 1], sr[e, 1], sa[e, 1] = c + 5 * fwd, 0.8, True
        elif case == "inactive":
            sc[e, 1], sr[e, 1] = c + 4 * view, 1.0
            cc[e, 1], cr[e, 1], ch[e, 1] = [c[0] + 3, c[1] - 0.3, 0.0], 0.5, 5.0
            cc[e, 0], cr[e, 0], ch[e, 0], ca[e, 0] = [c[0] + 5, c[1] + 2, 0.0], 0.4, 4.0, True
        elif case == "cylinder_band":
            cc[e, 0], cr[e, 0], ch[e, 0], ca[e, 0] = [c[0] + 3, c[1] + 0.5, 0.0], 0.6, 10.0, True
            cc[e, 1], cr[e, 1], ch[e, 1], ca[e, 1] = [c[0], c[1], 0.0], 2.5, 2.5, True
        elif case == "down_axis":
            cc[e, 0], cr[e, 0], ch[e, 0], ca[e, 0] = [c[0], c[1], 0.0], 0.8, 1.0, True
            cc[e, 1], cr[e, 1], ch[e, 1], ca[e, 1] = [c[0], c[1], 0.0], 1.5, 2.0, True
        elif case == "gate_edge_behind":
            gp[e, 0], gR[e, 0], ga[e, 0] = [c[0] + 4, c[1], c[2] + 0.5], _facing([0, 1, 0]), True
            gp[e, 1], gR[e, 1], ga[e, 1], gsh[e, 1] = c - 3 * view, _facing(view), True, 1
        elif case == "on_ground":
            cc[e, 0], cr[e, 0], ch[e, 0], ca[e, 0] = [c[0] + 4, c[1], 0.0], 0.5, 3.0, True
        elif case == "gate_shapes":
            gp[e, 0], ga[e, 0], gsh[e, 0] = c + 5 * fwd, True, 1
            gp[e, 1], gs[e, 1], ga[e, 1], gsh[e, 1] = c + 6 * fwd + [0.0, 2.5, -0.5], 1.5, True, 2
        else:  # open_view
            gp[e, 0], ga[e, 0] = c + 6 * fwd + [0.0, -2.0, 0.0], True
            cc[e, 0], cr[e, 0], ch[e, 0], ca[e, 0] = [c[0] + 4, c[1] + 1.5, 0.0], 0.5, 3.0, True
            sc[e, 1], sr[e, 1], sa[e, 1] = c + 5 * view, 0.7, True
    dev = resolve_device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=dev)

    base = empty_world(2, 2, 2, dtype=dtype, device=dev)
    world = base.replace(
        sphere_center=t(sc), sphere_radius=t(sr), sphere_active=t(sa, torch.bool),
        sphere_path_center=t(sc), sphere_path_radius=t(np.zeros((n, 2))),
        sphere_path_res=t(np.ones((n, 2)), torch.int32),
        sphere_path_count=t(np.zeros((n, 2)), torch.int32),
        sphere_has_path=t(np.zeros((n, 2)), torch.bool),
        cyl_center=t(cc), cyl_radius=t(cr), cyl_height=t(ch), cyl_active=t(ca, torch.bool),
        gate_pos=t(gp), gate_rotmat=t(gR), gate_size=t(gs), gate_active=t(ga, torch.bool),
        gate_shape=t(gsh, torch.int32), has_ground=t(np.ones(n), torch.bool))
    return world, pos.astype(np.float32), quat.astype(np.float32)


def race_edge_start(world, n: int, rig, obstacle_period: int):
    """The race track ``world`` (its gates 1 and 2 moved) and ``n`` drone
    positions (n, 3), level and facing +x (quaternion 1, 0, 0, 0), for a
    race at episode time 0: env e is :data:`RACE_EDGE_CASES` [e % 4] for the
    camera of ``rig``:

    0. the camera at obstacle 0's centre (inside it);
    1. the camera where obstacle 0 will be two steps on, on its orbit;
    2. gate 1 edge-on to the camera (its plane holds the camera exactly);
    3. gate 2 behind the camera, facing it.

    Obstacle 0 orbits the track's centre at the track radius, from count 0
    with ``obstacle_period`` points a revolution (``MultiRaceEnv``)."""
    rel = np.asarray(rig.rel_position, np.float64)
    view = np.asarray(rig.mount_rotation, np.float64)[:, 2]
    centre = world.sphere_path_center[0].double().cpu().numpy()
    radius = float(world.sphere_path_radius[0])
    pos = np.zeros((n, 3))
    for e in range(n):
        case = RACE_EDGE_CASES[e % len(RACE_EDGE_CASES)]
        if case in ("inside_obstacle", "obstacle_arrives"):
            theta = 2 * np.pi * (0 if case == "inside_obstacle" else 2) / obstacle_period
            pos[e] = centre + radius * np.array([np.cos(theta), np.sin(theta), 0.0]) - rel
        else:
            pos[e] = [0.0, 2.0 * (e % len(RACE_EDGE_CASES)), 2.0]
    pos = pos.astype(np.float32)
    # at a level body the camera is pos + rel: gate 1 in the plane y = c.y
    # of env 2's camera, gate 2 three metres behind env 3's
    c2 = pos[2 % n] + rel.astype(np.float32)
    c3 = pos[3 % n] + rel.astype(np.float32)
    gate_pos = world.gate_pos.clone()
    gate_rot = world.gate_rotmat.clone()
    kw = dict(dtype=gate_pos.dtype, device=gate_pos.device)
    gate_pos[1] = torch.as_tensor([c2[0] + 4.0, c2[1], c2[2] + 0.5], **kw)
    gate_rot[1] = torch.as_tensor(_facing([0.0, 1.0, 0.0]), **kw)
    gate_pos[2] = torch.as_tensor(c3 - 3.0 * view, **kw)
    gate_rot[2] = torch.as_tensor(_facing(view), **kw)
    return world.replace(gate_pos=gate_pos, gate_rotmat=gate_rot), pos
