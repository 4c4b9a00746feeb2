"""Device selection shared by the port's entry points, and the divisor that
keeps a division on the device a true division."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Asking for CUDA where there is none raises: the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def divisor(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device. PyTorch's CUDA division
    by a Python scalar multiplies by its reciprocal, which rounds otherwise
    than the kernels' true division; a divisor on the device divides."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)
