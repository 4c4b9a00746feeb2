"""RL (mirrors ``fpyv_tpu.rl``): GAE and the PPO learner."""

from fpyv_tpu_torch.rl.gae import compute_gae  # noqa: F401
from fpyv_tpu_torch.rl.ppo import PpoConfig, PpoState, Transition, make_ppo, scan_train  # noqa: F401
