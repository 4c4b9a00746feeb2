"""Gym-style adapter: the classic reset()/step() API over the functional
envs (mirrors ``fpyv_tpu.envs.gym_adapter``).

The reference exposes its envs through gym.Env (tests/rotation_pid.py:11,
find_by_distance.py:6, ma_com_simple_env.py:17). This adapter gives users
of that API the same shape — numpy in and out, an internal generator,
batched under the hood — without the gym package:

    env = GymAdapter(AcroEnv(), num_envs=16, seed=0, env_args=(world,))
    obs = env.reset()
    obs, reward, done, info = env.step(actions)  # numpy (16, ...) arrays
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import tree_map_tensors


def _to_numpy(tree):
    return tree_map_tensors(lambda x: x.detach().cpu().numpy(), tree)


class GymAdapter:
    """Stateful host-side wrapper over a functional env.

    Works with any env of the port's convention:
    ``reset(generator, *args, batch_shape=(), device=None, part=None)`` and
    ``step(state, action, *args, generator=None, part=None)``. Extra
    positional args (the world, ...) are bound at construction. With
    ``num_envs == 1`` the env is unbatched (``batch_shape=()``), as JAX's
    adapter does without vmap. The draws come from a ``torch.Generator``
    seeded with ``seed``; the envs run on ``device`` (CUDA unless told).
    """

    def __init__(self, env, num_envs: int = 1, seed: int = 0, env_args=(), device=None):
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self._args = tuple(env_args)
        self._gen = torch.Generator().manual_seed(seed)
        self._state = None

    @property
    def _batch_shape(self) -> tuple:
        return (self.num_envs,) if self.num_envs > 1 else ()

    def reset(self) -> Any:
        self._state, obs = self.env.reset(self._gen, *self._args, batch_shape=self._batch_shape,
                                          device=self.device)
        return _to_numpy(obs)

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        if isinstance(action, dict):
            action = {k: torch.as_tensor(np.array(v), device=self.device)
                      for k, v in action.items()}
        else:
            action = torch.as_tensor(np.array(action), device=self.device)
        self._state, obs, reward, done, info = self.env.step(self._state, action, *self._args,
                                                             generator=self._gen)
        return _to_numpy(obs), _to_numpy(reward), _to_numpy(done), _to_numpy(info)

    def close(self) -> None:
        pass

    def seed(self, seed: Optional[int] = None) -> None:
        if seed is not None:
            self._gen.manual_seed(seed)
