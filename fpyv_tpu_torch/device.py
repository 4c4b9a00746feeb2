"""Device selection shared by the port's entry points."""

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
