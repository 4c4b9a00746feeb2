"""Ring replay buffer on the training device for the off-policy learner
(mirrors ``fpyv_tpu.rl.replay``).

The buffer is preallocated float32 tensors on the device. Where the JAX
buffer is an immutable pytree whose ``.at[idx].set`` returns a new one, this
one writes its tensors in place and returns a new :class:`ReplayBuffer`
that holds them, with the ring pointer and the fill level advanced. Those
two are host integers: they follow from the insert's batch size alone, so
neither an insert nor a sample reads anything back from the device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from fpyv_tpu_torch.device import resolve_device

_FIELDS = ("obs", "action", "reward", "next_obs", "done")


@dataclass
class ReplayBuffer:
    obs: torch.Tensor  # (cap, O)
    action: torch.Tensor  # (cap, A)
    reward: torch.Tensor  # (cap,)
    next_obs: torch.Tensor  # (cap, O)
    done: torch.Tensor  # (cap,)
    ptr: int  # next write slot
    size: int  # valid entries

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def replace(self, **changes) -> "ReplayBuffer":
        return dataclasses.replace(self, **changes)


def replay_init(capacity: int, obs_dim: int, action_dim: int, dtype=torch.float32,
                device=None) -> ReplayBuffer:
    """An empty buffer of ``capacity`` transitions on ``device`` (CUDA unless
    told)."""
    device = resolve_device(device)
    kw = dict(dtype=dtype, device=device)
    return ReplayBuffer(obs=torch.zeros((capacity, obs_dim), **kw),
                        action=torch.zeros((capacity, action_dim), **kw),
                        reward=torch.zeros((capacity,), **kw),
                        next_obs=torch.zeros((capacity, obs_dim), **kw),
                        done=torch.zeros((capacity,), **kw), ptr=0, size=0)


def replay_add_batch(buf: ReplayBuffer, obs, action, reward, next_obs, done) -> ReplayBuffer:
    """Insert the N transitions at ``(ptr + arange(N)) mod capacity``, each
    cast to the buffer's dtype. The writes are at most two slices of the
    ring; where N exceeds the capacity, only the last ``capacity`` rows are
    written (a later row wins the slot it shares with an earlier one)."""
    n, cap = obs.shape[0], buf.capacity
    values = dict(obs=obs, action=action, reward=reward, next_obs=next_obs, done=done)
    skip = max(0, n - cap)
    start = (buf.ptr + skip) % cap
    for name in _FIELDS:
        dst, src = getattr(buf, name), values[name][skip:]
        src = src.to(device=dst.device, dtype=dst.dtype)
        head = min(src.shape[0], cap - start)
        dst[start:start + head] = src[:head]
        dst[:src.shape[0] - head] = src[head:]
    return buf.replace(ptr=(buf.ptr + n) % cap, size=min(buf.size + n, cap))


def replay_indices(batch_size: int, high: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """``batch_size`` slots uniform over ``[0, high)`` with replacement,
    drawn on the generator's device (the SAC tests replace this seam with
    JAX's ``randint`` draws)."""
    return torch.randint(0, high, (batch_size,), generator=generator,
                         device=generator.device).to(device)


def replay_sample(buf: ReplayBuffer, generator: torch.Generator, batch_size: int):
    """Uniform sample with replacement over the valid prefix: (obs, action,
    reward, next_obs, done)."""
    idx = replay_indices(batch_size, max(buf.size, 1), generator, buf.obs.device)
    return tuple(getattr(buf, name)[idx] for name in _FIELDS)
