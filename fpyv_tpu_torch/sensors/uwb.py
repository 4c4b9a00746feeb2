"""UWB range sensor: true range clamped to the sensor's max range (mirrors
``fpyv_tpu.sensors.uwb``).

Reference parity (components.py:287):
``measured = min(target.calculate_distance(position), UWB_sensor_max_range)``
— the reference clamps the *SDF* distance (range minus target radius).
Optional Gaussian noise, drawn from a ``torch.Generator``, extends the model.
"""

from __future__ import annotations

from typing import Optional

import torch


def uwb_range(position: torch.Tensor, target_center: torch.Tensor, target_radius=0.0,
              max_range: float = 13.0, generator: Optional[torch.Generator] = None,
              noise_std: float = 0.0) -> torch.Tensor:
    """Batched UWB range: position (..., 3), target_center (..., 3),
    target_radius (...,) or scalar."""
    d = torch.linalg.vector_norm(target_center - position, dim=-1) - target_radius
    if generator is not None and noise_std > 0.0:
        noise = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                            device=generator.device).to(d.device)
        d = d + noise_std * noise
    return torch.clamp_max(d, max_range)
