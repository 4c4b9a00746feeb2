"""Trail: fixed-size ring buffer of past positions (for debug rendering);
the port of ``fpyv_tpu.viz.trail``.

Parity: components.py:631-646 — the reference grows an unbounded vstack and
keeps the last `trail_length` rows. Here a static ring buffer of tensors
that batches over leading dims; trails never collide (excluded with gates,
components.py:203) and are render-only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Trail:
    points: torch.Tensor  # (..., L, 3)
    head: torch.Tensor  # (...,) int32 next write slot
    count: torch.Tensor  # (...,) int32 valid entries (<= L)

    @classmethod
    def create(cls, length: int, position, batch_shape=()) -> "Trail":
        position = torch.as_tensor(position)
        batch_shape = tuple(batch_shape)
        pts = torch.zeros(batch_shape + (length, 3), dtype=position.dtype,
                          device=position.device)
        pts[..., 0, :] = position
        ones = torch.ones(batch_shape, dtype=torch.int32, device=position.device)
        return cls(points=pts, head=ones, count=ones.clone())

    def update(self, position) -> "Trail":
        L = self.points.shape[-2]
        position = torch.as_tensor(position, dtype=self.points.dtype,
                                   device=self.points.device)
        # a masked write along L serves scalar and batched heads alike
        slot = torch.arange(L, dtype=torch.int32, device=self.points.device)
        write = slot == torch.remainder(self.head, L)[..., None]
        pts = torch.where(write[..., None], position[..., None, :], self.points)
        return Trail(points=pts, head=torch.remainder(self.head + 1, L),
                     count=torch.clamp_max(self.count + 1, L))

    def ordered(self) -> torch.Tensor:
        """(..., L, 3) oldest-first (invalid slots repeat the newest point)."""
        L = self.points.shape[-2]
        lane = torch.arange(L, dtype=torch.int32, device=self.points.device)
        head = self.head[..., None]
        count = self.count[..., None]
        idx = torch.remainder(head - count + lane, L)
        # clamp the tail for partially-filled buffers
        idx = torch.where(lane < count, idx, torch.remainder(head - 1, L))
        idx = idx.to(torch.int64)[..., None].expand(idx.shape + (3,))
        return torch.gather(self.points, -2, idx)


def render_trail(ax, trail: Trail, **kwargs):
    """Plot the trail polyline (components.py:645-646)."""
    from fpyv_tpu_torch.viz.render3d import plot_3d_line

    plot_3d_line(ax, trail.ordered(), **kwargs)
