"""uint8 depth levels into the pixel net's input dtype: the CUDA kernel
levels_lut (``csrc/levels_kernels.cu``) with its plain PyTorch version.

:func:`levels_as` gives ``dtype(float32(u) / 255)`` for uint8 levels u, in
bf16, fp16 or float32: the input chain of
:class:`~fpyv_tpu_torch.models.policy.PixelActorCritic`. The plain version
is the chain itself (a u8 -> float32 copy, a float32 true division, a cast:
three passes); the kernel reads each level once and writes its value from
a 256-entry table (:func:`level_table`) that the plain version computes on
the device, so the two agree bit for bit. It replaces no TPU kernel: XLA
fused the chain on the TPU.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel, and
anything the kernel does not take raises.
"""

from __future__ import annotations

import functools

import torch

from fpyv_tpu_torch.device import divisor
from fpyv_tpu_torch.ops import _build

LEVEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def levels_reference(levels: torch.Tensor, dtype: torch.dtype,
                     scale: torch.Tensor) -> torch.Tensor:
    """Plain version of levels_lut: ``dtype(float32(u) / scale)``, a true
    division by the float32 ``scale`` (255) on the levels' device."""
    return (levels.to(torch.float32) / scale).to(dtype)


@functools.lru_cache(maxsize=16)
def level_table(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The 256 values of :func:`levels_reference` for u = 0..255, made on
    ``device`` once per device and dtype (read only). A CUDA graph that
    launches levels_lut reads the table's address, so the table is made
    before the capture (the learner's eager warm-up does), never inside it."""
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("levels_as: the level table must exist before a CUDA graph capture")
    u = torch.arange(256, dtype=torch.uint8, device=device)
    return levels_reference(u, dtype, divisor(255.0, u))


def launch_levels_lut(levels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """levels_lut on the card: the table's values at the levels, one pass on
    the current stream, no host sync."""
    device = levels.device
    if device.type != "cuda":
        raise ValueError(f"levels_lut launches on a CUDA device, got {device}")
    table = level_table(device, dtype)
    out = torch.empty(levels.shape, dtype=dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _build.library().fpyv_levels_lut(levels.data_ptr(), table.data_ptr(),
                                               out.data_ptr(), levels.numel(),
                                               out.element_size(), stream)
    _build.check(err, "levels_lut")
    _build.launch_counts["levels_lut"] += 1
    return out


def levels_as(levels: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor) -> torch.Tensor:
    """Contiguous uint8 levels as ``dtype`` (bf16, fp16 or float32):
    ``dtype(float32(u) / 255)``, bit for bit. ``scale`` is the float32 255
    on the levels' device that the plain version divides by (the pixel net's
    ``level_scale``); on the card levels_lut reads the same quotients from
    :func:`level_table` (reading ``scale``'s value there would sync)."""
    if levels.dtype != torch.uint8:
        raise TypeError(f"levels must be uint8, got {levels.dtype}")
    if not levels.is_contiguous():
        raise ValueError("levels must be contiguous")
    if dtype not in LEVEL_DTYPES:
        raise TypeError(f"levels_as gives one of {LEVEL_DTYPES}, got {dtype}")
    if scale.device != levels.device or scale.dtype != torch.float32 or scale.ndim != 0:
        raise ValueError(f"scale must be a float32 scalar on {levels.device}")
    if levels.device.type == "cpu":
        return levels_reference(levels, dtype, scale)
    return launch_levels_lut(levels, dtype)
