"""Procedural terrain from a random sin-activation MLP (mirrors
``fpyv_tpu.models.terrain``).

Reference parity (src/utils/terrainn.py:7-44 ``TerraiNN``): a randomly
initialized MLP with Sin activations maps (x, y) -> height, giving smooth
Perlin-like terrain; the demo normalizes by the max and exponentiates
(:37-38). Layer sizes [2, *hidden, 1]; standard-normal init.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.models import nn


class TerrainNet:
    """A generator-seeded terrain field: the weights live in the instance,
    the evaluation is a function of them (``viz.render3d.plot_3d_grid_func``
    takes it as a height function)."""

    def __init__(self, generator: torch.Generator, hidden_layers: Sequence[int] = (10, 10),
                 dtype=torch.float32, device=None):
        self.params = nn.mlp_init(generator, (2, *hidden_layers, 1), dtype=dtype,
                                  device=resolve_device(device))

    @classmethod
    def from_params(cls, params: List[nn.Params]) -> "TerrainNet":
        """A net over given MLP layers (``interop.mlp_params_from_numpy``
        carries JAX's across)."""
        net = cls.__new__(cls)
        net.params = params
        return net

    def __call__(self, xy: torch.Tensor) -> torch.Tensor:
        """xy: (..., 2) -> height (...,)."""
        return nn.mlp_apply(self.params, xy, activation=nn.sin)[..., 0]


def terrain_heightmap(generator: torch.Generator, scale: float = 5.0, resolution: int = 100,
                      hidden_layers: Sequence[int] = (10, 10), normalize_exp: bool = True,
                      dtype=torch.float32, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """A grid heightmap like terrainn.py's __main__ (:29-44), on ``device``
    (CUDA unless told).

    Returns (xy grid (R², 2), heights (R²,)); with ``normalize_exp`` the
    reference's z/max -> exp(z) post-processing is applied.
    """
    device = resolve_device(device)
    net = TerrainNet(generator, hidden_layers, dtype, device)
    axis = torch.linspace(-scale, scale, resolution, dtype=dtype, device=device)
    xx, yy = torch.meshgrid(axis, axis, indexing="xy")
    xy = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)
    z = net(xy)
    if normalize_exp:
        z = torch.exp(z / z.max())
    return xy, z
