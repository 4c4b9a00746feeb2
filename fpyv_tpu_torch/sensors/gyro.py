"""Gyro noise model: a random small-rotation perturbation of the attitude
(mirrors ``fpyv_tpu.sensors.gyro``).

Reference parity (tests/rotation_pid.py:163-171): per step,
``current <- E(deg2rad(N(0, σ)³ mod 2π)) @ current`` — Gaussian noise in
DEGREES, the reference's quirky ``mod 2π`` taken in degree space (values
beyond ~6.28° wrap), then converted to radians and composed as a
world-side rotation. σ defaults to the reference's noise_lvl = 5.0.

The normal draw comes from a ``torch.Generator`` through
:func:`noise_draw`, which the tests replace with JAX's draws.
"""

from __future__ import annotations

import math

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.ops import rotations as rot


def mod_two_pi(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, 2π)``: the exact remainder, taking the divisor's sign
    (``torch.fmod`` keeps the dividend's, so a negative one is shifted)."""
    two_pi = torch.tensor(2.0 * math.pi, dtype=x.dtype, device=x.device)
    r = torch.fmod(x, two_pi)
    return torch.where(r < 0, r + two_pi, r)


def noise_draw(generator: torch.Generator, batch_shape, dtype, device) -> torch.Tensor:
    """The noise's standard normal draw, (*batch_shape, 3)."""
    return torch.randn(tuple(batch_shape) + (3,), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def gyro_noise_rotation(generator: torch.Generator, sigma_deg: float = 5.0, batch_shape=(),
                        dtype=torch.float32, mod_quirk: bool = True,
                        device=None) -> torch.Tensor:
    """The per-step noise rotation matrices, (*batch_shape, 3, 3), on
    ``device`` (CUDA unless told)."""
    noise_deg = sigma_deg * noise_draw(generator, batch_shape, dtype, resolve_device(device))
    if mod_quirk:  # rotation_pid.py:171 takes mod 2π of degree values
        noise_deg = mod_two_pi(noise_deg)
    return rot.euler_to_rotmat(torch.deg2rad(noise_deg))


def perturb_attitude(generator: torch.Generator, R: torch.Tensor, sigma_deg: float = 5.0,
                     mod_quirk: bool = True) -> torch.Tensor:
    """``E_noise @ R`` with E_noise from :func:`gyro_noise_rotation`, on
    ``R``'s device."""
    N = gyro_noise_rotation(generator, sigma_deg, tuple(R.shape[:-2]), R.dtype, mod_quirk,
                            R.device)
    return rot.mat3_mul(N, R)
