"""UWB range sensor: true range clamped to the sensor's max range (mirrors
``fpyv_tpu.sensors.uwb``).

Reference parity (components.py:287):
``measured = min(target.calculate_distance(position), UWB_sensor_max_range)``
— the reference clamps the *SDF* distance (range minus target radius).
Optional Gaussian noise extends the model, drawn from a ``torch.Generator``
through :func:`range_noise`.
"""

from __future__ import annotations

from typing import Optional

import torch


def range_noise(generator: torch.Generator, batch_shape, dtype, device) -> torch.Tensor:
    """The range noise's standard normal draw, (*batch_shape)."""
    return torch.randn(tuple(batch_shape), generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def uwb_range(position: torch.Tensor, target_center: torch.Tensor, target_radius=0.0,
              max_range: float = 13.0, generator: Optional[torch.Generator] = None,
              noise_std: float = 0.0, part=None) -> torch.Tensor:
    """Batched UWB range: position (..., 3), target_center (..., 3),
    target_radius (...,) or scalar. Under ``part`` (an
    :class:`~fpyv_tpu_torch.envs.base.Part`) the noise is drawn for the
    whole bank and sliced."""
    d = torch.linalg.vector_norm(target_center - position, dim=-1) - target_radius
    if generator is not None and noise_std > 0.0:
        # imported here: the envs package imports the sensors
        from fpyv_tpu_torch.envs.base import draw_shape, take_part

        d = d + noise_std * take_part(
            range_noise(generator, draw_shape(d.shape, part), d.dtype, d.device), part)
    return torch.clamp_max(d, max_range)
