"""Rotation representations: Euler <-> matrix <-> quaternion <-> axis-angle
(mirrors ``fpyv_tpu.ops.rotations`` function by function).

Conventions are the JAX package's: Euler angles are (roll, pitch, yaw) with
``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``; quaternions are (w, x, y, z); every
function takes arbitrary leading batch dims (``R: (..., 3, 3)``,
``q: (..., 4)``, ``euler: (..., 3)``).

Precision: every 3x3 product here is written out elementwise in the input
dtype. A matmul would let a float32 chain run through TF32 on the card
(cuBLAS/cuDNN settings), and attitude error compounds over thousands of
steps — the JAX package pins ``precision="highest"`` for the same reason.
"""

from __future__ import annotations

import math

import torch

from fpyv_tpu_torch.device import resolve_device


def mat3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product ``a @ b``, elementwise (see module note)."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def mat3_vec(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R @ v`` batched."""
    return (R[..., :, 0] * v[..., 0:1] + R[..., :, 1] * v[..., 1:2]
            + R[..., :, 2] * v[..., 2:3])


def mat3_vec_T(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``Rᵀ @ v`` batched."""
    return (R[..., 0, :] * v[..., 0:1] + R[..., 1, :] * v[..., 1:2]
            + R[..., 2, :] * v[..., 2:3])


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


# --------------------------------------------------------------------------
# Euler <-> rotation matrix
# --------------------------------------------------------------------------


def euler_to_rotmat(euler: torch.Tensor) -> torch.Tensor:
    """``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)`` in closed form
    (helper_functions.py:39-44)."""
    roll, pitch, yaw = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return _mat([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def rotmat_to_euler(R: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`euler_to_rotmat`, generic branch only
    (helper_functions.py:47-62; the singular branch is dead code there)."""
    x = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    y = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    z = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([x, y, z], dim=-1)


def rotmat_x(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[o, z, z], [z, c, -s], [z, s, c]])


def rotmat_y(angle: torch.Tensor) -> torch.Tensor:
    """Standard Ry (the reference's 'y' branch leaves dR[1,1]=1)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[c, z, s], [z, o, z], [-s, z, c]])


def rotmat_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


# --------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# --------------------------------------------------------------------------


def quat_identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternions on ``device`` (CUDA unless told)."""
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=dtype, device=resolve_device(device))
    q[..., 0] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b``."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """helper_functions.py:100-117."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _mat([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Matrix -> quaternion by Shepperd's method: the reference's trace
    formula on its valid domain, finite everywhere, canonical sign w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, 1e-12))

    sw = safe_sqrt(1.0 + tr)
    inv_sw = 0.5 / sw
    cand_w = torch.stack([0.5 * sw, (m21 - m12) * inv_sw, (m02 - m20) * inv_sw,
                          (m10 - m01) * inv_sw], dim=-1)
    sx = safe_sqrt(1.0 + m00 - m11 - m22)
    inv_sx = 0.5 / sx
    cand_x = torch.stack([(m21 - m12) * inv_sx, 0.5 * sx, (m01 + m10) * inv_sx,
                          (m02 + m20) * inv_sx], dim=-1)
    sy = safe_sqrt(1.0 - m00 + m11 - m22)
    inv_sy = 0.5 / sy
    cand_y = torch.stack([(m02 - m20) * inv_sy, (m01 + m10) * inv_sy, 0.5 * sy,
                          (m12 + m21) * inv_sy], dim=-1)
    sz = safe_sqrt(1.0 - m00 - m11 + m22)
    inv_sz = 0.5 / sz
    cand_z = torch.stack([(m10 - m01) * inv_sz, (m02 + m20) * inv_sz,
                          (m12 + m21) * inv_sz, 0.5 * sz], dim=-1)

    choice = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    idx = choice[..., None, None].expand(choice.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0).to(q.dtype)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], torch.sin(half)[..., None] * axis],
                     dim=-1)


def euler_to_quat(euler: torch.Tensor) -> torch.Tensor:
    """Quaternion of ``Rz(yaw) @ Ry(pitch) @ Rx(roll)``: ``qz ⊗ qy ⊗ qx``."""
    half = 0.5 * euler
    cr, sr = torch.cos(half[..., 0]), torch.sin(half[..., 0])
    cp, sp = torch.cos(half[..., 1]), torch.sin(half[..., 1])
    cy, sy = torch.cos(half[..., 2]), torch.sin(half[..., 2])
    return torch.stack([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q) @ v`` without forming R."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_inverse_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``R(q).T @ v``."""
    return quat_rotate(quat_conj(q), v)


# --------------------------------------------------------------------------
# Axis-angle
# --------------------------------------------------------------------------


def rotmat_to_axis_angle(R: torch.Tensor):
    """helper_functions.py:156-174 on the generic branch, with the JAX
    package's guards near angle 0 (axis -> [1, 0, 0]) and near pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = torch.acos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    raw = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    nrm = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
    generic = raw / torch.clamp_min(nrm, 1e-12)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    pi_axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    pi_axis = pi_axis * torch.stack([
        torch.ones_like(pi_axis[..., 0]),
        torch.sign(R[..., 0, 1] + R[..., 1, 0] + 1e-30),
        torch.sign(R[..., 0, 2] + R[..., 2, 0] + 1e-30),
    ], dim=-1)
    pi_axis = pi_axis / torch.clamp_min(
        torch.linalg.vector_norm(pi_axis, dim=-1, keepdim=True), 1e-12)
    near_pi = (torch.abs(angle - math.pi) < 1e-4)[..., None]
    near_zero = (angle < 1e-7)[..., None]
    e0 = torch.zeros_like(generic)
    e0[..., 0] = 1.0
    axis = torch.where(near_zero, e0, torch.where(near_pi, pi_axis, generic))
    return axis, angle


def axis_angle_to_rotmat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues form (helper_functions.py:177-193)."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    t = 1.0 - c
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    return _mat([
        [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
        [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
    ])


# --------------------------------------------------------------------------
# Body-rate attitude updates (the reference's integrator core)
# --------------------------------------------------------------------------


def rotate_body_by_rates(R: torch.Tensor, rates_deg: torch.Tensor, dt) -> torch.Tensor:
    """kinematics.py:27-30: ``R <- (E(deg2rad(rates)·dt) @ R.T).T``
    = ``R @ E.T`` — a small-angle Euler composition, not the SO(3) exp."""
    E = euler_to_rotmat(torch.deg2rad(rates_deg) * dt)
    return mat3_mul(R, E.transpose(-1, -2))


def quat_rotate_by_rates(q: torch.Tensor, rates_deg: torch.Tensor, dt) -> torch.Tensor:
    """Quaternion twin of :func:`rotate_body_by_rates`:
    ``R @ E.T  <=>  q ⊗ conj(q_E)``."""
    qE = euler_to_quat(torch.deg2rad(rates_deg) * dt)
    return quat_normalize(quat_mul(q, quat_conj(qE)))


# --------------------------------------------------------------------------
# Misc geometry helpers
# --------------------------------------------------------------------------


def distance_point_to_plane(point: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """|ax+by+cz+d| / ||(a,b,c)|| (helper_functions.py:83-85)."""
    n = plane[..., :3]
    return torch.abs((point * n).sum(-1) + plane[..., 3]) / torch.linalg.vector_norm(n, dim=-1)


def generate_circular_path(center, radius, resolution: int, dtype=torch.float32,
                           device=None) -> torch.Tensor:
    """``resolution`` points on a circle in the z=center_z plane
    (helper_functions.py:151-153: ``linspace(0, 2pi, n+1)[:-1]``), on
    ``device`` (CUDA unless told)."""
    device = resolve_device(device)
    theta = torch.linspace(0.0, 2.0 * math.pi, resolution + 1, dtype=dtype,
                           device=device)[:-1]
    circle = torch.stack([torch.cos(theta) * radius, torch.sin(theta) * radius,
                          torch.zeros_like(theta)], dim=-1)
    return circle + torch.as_tensor(center, dtype=dtype, device=device)
