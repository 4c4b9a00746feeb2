"""Geometry algorithms: epipolar, multilateration, ICP, sphere sampling
(mirrors ``fpyv_tpu.vision.geometry``).

Counterparts of the reference's vision/geometry experiment scripts, which
are untested sketches (tests/eight_point_algorithm.py:1), implemented
correctly:

- :func:`eight_point` — normalized 8-point fundamental matrix (Hartley
  normalization + rank-2 enforcement);
- :func:`triangulate` — DLT two-view triangulation, batched over points;
- :func:`trilaterate_gd` — range-only positioning by gradient descent on
  the squared range residuals (the working shape of tests/positioning.py:28-51);
- :func:`trilaterate_gauss_newton` — the fast solver of the same problem;
- :func:`icp_2d` — 2D iterative closest point with brute-force
  correspondences and Procrustes updates;
- :func:`random_points_on_sphere` — uniform sphere sampling
  (tests/monte_carlo_search.py:16-24).

An SVD's singular vectors are defined up to sign: ``eight_point``'s F
equals JAX's up to sign, and ``triangulate``'s ``X[:3] / X[3]`` does not
depend on it. Float32 products here reach cuBLAS and cuSOLVER on the card,
where PyTorch's default keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32``).
The iterative solvers run their iterations as a Python loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from fpyv_tpu_torch.device import resolve_device


def _normalize_points(pts: torch.Tensor):
    """Hartley normalization: zero mean, mean distance sqrt(2)."""
    mean = pts.mean(0)
    centered = pts - mean
    scale = math.sqrt(2.0) / torch.clamp_min(
        torch.linalg.vector_norm(centered, dim=1).mean(), 1e-12)
    z, o = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([torch.stack([scale, z, -scale * mean[0]]),
                     torch.stack([z, scale, -scale * mean[1]]),
                     torch.stack([z, z, o])])
    homog = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    return homog @ T.T, T


def eight_point(points1: torch.Tensor, points2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrix from N>=8 correspondences, x2ᵀ F x1 = 0.

    points1, points2: (N, 2) pixel coordinates. Returns (3, 3) F with
    ||F|| = 1 and rank 2.
    """
    p1, T1 = _normalize_points(points1)
    p2, T2 = _normalize_points(points2)
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)],
                    dim=1)
    F = torch.linalg.svd(A, full_matrices=True).Vh[-1].reshape(3, 3)
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[:2], torch.zeros_like(S[2:])])  # rank-2 enforcement
    F = T2.T @ ((U * S[None, :]) @ Vt2) @ T1  # unnormalize
    return F / torch.clamp_min(torch.linalg.matrix_norm(F), 1e-12)


def epipolar_residual(F: torch.Tensor, points1: torch.Tensor,
                      points2: torch.Tensor) -> torch.Tensor:
    """|x2ᵀ F x1| per correspondence (algebraic error)."""
    h1 = torch.cat([points1, torch.ones_like(points1[:, :1])], dim=1)
    h2 = torch.cat([points2, torch.ones_like(points2[:, :1])], dim=1)
    return (h2 * (h1 @ F.T)).sum(1).abs()


def triangulate(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor,
                pts2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: projection matrices (3, 4) + (N, 2) pixels -> (N, 3)."""
    A = torch.stack([pts1[:, 0:1] * P1[2] - P1[0], pts1[:, 1:2] * P1[2] - P1[1],
                     pts2[:, 0:1] * P2[2] - P2[0], pts2[:, 1:2] * P2[2] - P2[1]], dim=1)
    X = torch.linalg.svd(A).Vh[:, -1]
    return X[:, :3] / X[:, 3:4]


# ---------------------------------------------------------------------------
# Range-only positioning (UWB multilateration)
# ---------------------------------------------------------------------------


def trilaterate_gd(anchors, ranges, x0: Optional[torch.Tensor] = None,
                   learning_rate: float = 5e-3, iterations: int = 2000) -> torch.Tensor:
    """Gradient descent on sum((||a_i - x|| - r_i)²), the working form of
    tests/positioning.py's iterative approach. The gradient is written out:
    ``sum_i 2 (d_i - r_i) (x - a_i) / d_i``."""
    anchors = torch.as_tensor(anchors)
    ranges = torch.as_tensor(ranges, dtype=anchors.dtype, device=anchors.device)
    x = torch.zeros(anchors.shape[-1], dtype=anchors.dtype, device=anchors.device) \
        if x0 is None else torch.as_tensor(x0, dtype=anchors.dtype, device=anchors.device)
    for _ in range(iterations):
        diff = x - anchors
        d = torch.linalg.vector_norm(diff, dim=-1)
        x = x - learning_rate * (2.0 * ((d - ranges) / d)[:, None] * diff).sum(0)
    return x


def trilaterate_gauss_newton(anchors, ranges, x0: Optional[torch.Tensor] = None,
                             iterations: int = 20) -> torch.Tensor:
    """Gauss-Newton on the range residuals; converges in a few steps."""
    anchors = torch.as_tensor(anchors)
    ranges = torch.as_tensor(ranges, dtype=anchors.dtype, device=anchors.device)
    x = anchors.mean(0) if x0 is None else torch.as_tensor(x0, dtype=anchors.dtype,
                                                           device=anchors.device)
    eye = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        diff = x - anchors  # (N, D)
        d = torch.clamp_min(torch.linalg.vector_norm(diff, dim=-1), 1e-9)
        J = diff / d[:, None]  # the Jacobian of d in x
        step = torch.linalg.solve(J.T @ J + 1e-9 * eye, J.T @ (d - ranges))
        x = x - step
    return x


# ---------------------------------------------------------------------------
# 2D ICP
# ---------------------------------------------------------------------------


def icp_2d(source, target, iterations: int = 20):
    """Rigid 2D ICP: returns (R (2, 2), t (2,), rmse) aligning source to
    target. Brute-force nearest neighbours + closed-form Procrustes per
    iteration."""
    source = torch.as_tensor(source)
    target = torch.as_tensor(target, dtype=source.dtype, device=source.device)
    R = torch.eye(2, dtype=source.dtype, device=source.device)
    t = torch.zeros(2, dtype=source.dtype, device=source.device)
    for _ in range(iterations):
        moved = source @ R.T + t
        d2 = ((moved[:, None, :] - target[None, :, :]) ** 2).sum(-1)
        matched = target[d2.argmin(1)]
        mu_s, mu_t = moved.mean(0), matched.mean(0)
        U, _, Vt = torch.linalg.svd((moved - mu_s).T @ (matched - mu_t))
        d = torch.sign(torch.linalg.det(Vt.T @ U.T))
        D = torch.diag(torch.stack([torch.ones_like(d), d]))
        R_step = Vt.T @ D @ U.T
        R, t = R_step @ R, R_step @ t + (mu_t - R_step @ mu_s)
    moved = source @ R.T + t
    d2 = ((moved[:, None, :] - target[None, :, :]) ** 2).sum(-1)
    return R, t, torch.sqrt(d2.min(1).values.mean())


def sphere_draw(generator: torch.Generator, n_points: int, dim: int, dtype,
                device) -> torch.Tensor:
    """:func:`random_points_on_sphere`'s standard normal draw, (n_points, dim)."""
    return torch.randn((n_points, dim), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def random_points_on_sphere(generator: torch.Generator, n_points: int, dim: int = 3,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform points on the unit sphere (monte_carlo_search.py:16-24), on
    ``device`` (CUDA unless told)."""
    x = sphere_draw(generator, n_points, dim, dtype, resolve_device(device))
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-12)
