"""Polynomial evaluation/fitting for the motor thrust curve (mirrors
``fpyv_tpu.ops.poly``).

The fit stays on the host in numpy float64 (once, at config time); the
evaluation is a Horner chain on tensors in the tensor's own dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation. ``coeffs`` highest-degree-first (np.polyfit order),
    host numbers; each is rounded to ``x``'s dtype before use, as the JAX
    version casts them to the input dtype."""
    x = torch.as_tensor(x)
    c = torch.as_tensor(np.asarray(coeffs, np.float64), dtype=x.dtype,
                        device=x.device)
    acc = torch.full_like(x, 0.0) + c[0]
    for i in range(1, c.shape[-1]):
        acc = acc * x + c[i]
    return acc


def fit_poly_through_origin(x, y, degree: int = 3, origin: bool = True) -> np.ndarray:
    """Host-side float64 least-squares fit, reference-exact.

    Parity: src/utils/flight_time_calculator.py:43-52 (``model_xy``) — a plain
    ``np.polyfit`` of degree `degree` with the point (0, 0) *prepended* to the
    data when ``origin=True`` (the origin is a sample, not a constraint).
    Returns coefficients highest-degree-first (np.polyfit order).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if origin:
        x = np.append(0.0, x)
        y = np.append(0.0, y)
    return np.polyfit(x, y, degree)


def quadratic_fit(x, y) -> torch.Tensor:
    """Least-squares quadratic fit ``y = a x² + b x + c`` on tensors: (...,
    3) coefficients (a, b, c), batched over ``y``'s leading dims.

    The *correct* fit behind the baro peak detector's
    ``use_reference_fit=False`` (:mod:`fpyv_tpu_torch.sensors.baro`, which
    also keeps the reference's own ad-hoc fit). On CUDA ``torch.linalg.lstsq``
    solves only by QR (``gels``), which needs full rank; the design matrix
    ``[x², x, 1]`` of a series with at least three distinct times is full
    rank and tall, so QR solves the same problem as the SVD-based solve of
    the JAX version, up to rounding."""
    y = torch.as_tensor(y)
    x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    X = torch.stack([x * x, x, torch.ones_like(x)], dim=-1)
    batch = torch.broadcast_shapes(X.shape[:-2], y.shape[:-1])
    X = X.expand(batch + X.shape[-2:])
    coef = torch.linalg.lstsq(X, y.expand(batch + y.shape[-1:])[..., None]).solution
    return coef[..., 0]
