"""Functional RL environments over batched tensors (mirrors
``fpyv_tpu.envs``); auto-reset is folded into ``step``.

Every env takes the same calling convention, which ``GymAdapter`` and
``wrappers.evaluate_policy`` drive: ``reset(generator, *args,
batch_shape=(), device=None, part=None)`` and ``step(state, action, *args,
generator=None, part=None)``, ``args`` being the world where the env takes
one. Importing this package builds no kernel.
"""

from fpyv_tpu_torch.envs.base import tree_where  # noqa: F401
from fpyv_tpu_torch.envs.rotate import RotateEnv  # noqa: F401
from fpyv_tpu_torch.envs.acro import AcroEnv  # noqa: F401
from fpyv_tpu_torch.envs.ball import BallEnv  # noqa: F401
from fpyv_tpu_torch.envs.gridworld import MaComGridEnv  # noqa: F401
from fpyv_tpu_torch.envs.vision_acro import VisionAcroEnv  # noqa: F401
from fpyv_tpu_torch.envs.sensor_acro import SensorAcroEnv  # noqa: F401
from fpyv_tpu_torch.envs.hover import HoverEnv, HoverPilot  # noqa: F401
from fpyv_tpu_torch.envs.multi_race import MultiRaceEnv  # noqa: F401
from fpyv_tpu_torch.envs.vision_race import VisionRaceEnv  # noqa: F401
from fpyv_tpu_torch.envs.gym_adapter import GymAdapter  # noqa: F401
