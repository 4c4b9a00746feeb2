"""Two-agent communication gridworld, Instructor/Apprentice (mirrors
``fpyv_tpu.envs.gridworld``).

Reference parity (tests/ma_com_simple_env.py:17-57 ``MaComSimpleInstructions``):

- an N×N board with a one-hot state and a one-hot goal;
- the **Instructor** observes ``state - goal`` (the board difference) and
  emits a continuous 2-vector message;
- the **Apprentice** observes only the Instructor's previous message and
  picks one of 5 discrete moves (stay / roll the state ±1 along either
  axis — a torus, np.roll, :44-53);
- reward = sum(state * goal); done when they overlap (:54-55).

The one-hot board is kept as an int32 (row, col) pair; rolls are modular
index arithmetic (``torch.remainder``, whose result takes the divisor's
sign as ``jnp.mod``'s does: a move below 0 wraps to N-1). The batch
dimension is written out; the draws come from a ``torch.Generator``
through :func:`reset_draws`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from fpyv_tpu_torch.device import resolve_device
from fpyv_tpu_torch.envs.base import Part, default_generator, draw_shape, take_part, tree_where


def reset_draws(generator: torch.Generator, batch_shape, map_size: int, device):
    """A reset's draws: the agent's cell, then the goal's, each uniform
    over the board, (*batch_shape, 2) int32."""
    shape = tuple(batch_shape) + (2,)
    a = torch.randint(0, map_size, shape, generator=generator, device=generator.device)
    g = torch.randint(0, map_size, shape, generator=generator, device=generator.device)
    return a.to(device, torch.int32), g.to(device, torch.int32)


@dataclass
class GridState:
    agent_rc: torch.Tensor  # (..., 2) int32 (row, col) of the one-hot state
    goal_rc: torch.Tensor  # (..., 2) int32
    message: torch.Tensor  # (..., 2) last Instructor message
    done: torch.Tensor  # (...,) bool

    def replace(self, **changes) -> "GridState":
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class MaComGridEnv:
    map_size: int = 3
    auto_reset: bool = True
    dtype: torch.dtype = torch.float32

    def _fresh(self, generator, batch_shape, device, part: Optional[Part] = None) -> GridState:
        a, g = take_part(reset_draws(generator, draw_shape(batch_shape, part), self.map_size,
                                     device), part)
        return GridState(agent_rc=a, goal_rc=g,
                         message=torch.zeros(tuple(batch_shape) + (2,), dtype=self.dtype,
                                             device=device),
                         done=torch.zeros(tuple(batch_shape), dtype=torch.bool, device=device))

    def board(self, rc: torch.Tensor) -> torch.Tensor:
        """The one-hot board from (row, col), in the env's dtype."""
        r = F.one_hot(rc[..., 0].long(), self.map_size).to(self.dtype)
        c = F.one_hot(rc[..., 1].long(), self.map_size).to(self.dtype)
        return r[..., :, None] * c[..., None, :]

    def _obs(self, state: GridState) -> Dict[str, torch.Tensor]:
        # the Instructor sees state - goal (ma_com_simple_env.py:12-14,38);
        # the Apprentice sees the last message
        return {"Instructor": self.board(state.agent_rc) - self.board(state.goal_rc),
                "Apprentice": state.message}

    def reset(self, generator: torch.Generator, batch_shape=(), device=None,
              part: Optional[Part] = None):
        """A fresh state of ``batch_shape`` envs on ``device`` (CUDA unless
        told) and its observations."""
        state = self._fresh(generator, batch_shape, resolve_device(device), part)
        return state, self._obs(state)

    def step(self, state: GridState, action: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, part: Optional[Part] = None):
        """action = {"Instructor": (..., 2) float message, "Apprentice":
        (...,) integer move}. Moves (ma_com_simple_env.py:44-53): 0 stay,
        1 roll +row, 2 roll -row, 3 roll +col, 4 roll -col."""
        device = state.agent_rc.device
        move = torch.as_tensor(action["Apprentice"], device=device)
        zero = torch.zeros_like(move)
        drow = torch.where(move == 1, 1, torch.where(move == 2, -1, zero))
        dcol = torch.where(move == 3, 1, torch.where(move == 4, -1, zero))
        agent_rc = torch.stack([torch.remainder(state.agent_rc[..., 0] + drow, self.map_size),
                                torch.remainder(state.agent_rc[..., 1] + dcol, self.map_size)],
                               dim=-1).to(torch.int32)
        reward = (agent_rc == state.goal_rc).all(-1).to(self.dtype)
        done = reward > 0
        message = torch.as_tensor(action["Instructor"], dtype=self.dtype, device=device)
        next_state = state.replace(agent_rc=agent_rc,
                                   message=message.expand(agent_rc.shape).clone(), done=done)
        if self.auto_reset:
            generator = default_generator(device) if generator is None else generator
            next_state = tree_where(done, self._fresh(generator, tuple(done.shape), device, part),
                                    next_state)
        return next_state, self._obs(next_state), reward, done, {}
