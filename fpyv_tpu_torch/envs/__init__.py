"""Functional RL environments over batched tensors (mirrors
``fpyv_tpu.envs``); auto-reset is folded into ``step``."""

from fpyv_tpu_torch.envs.base import tree_where  # noqa: F401
from fpyv_tpu_torch.envs.rotate import RotateEnv  # noqa: F401
from fpyv_tpu_torch.envs.acro import AcroEnv  # noqa: F401
