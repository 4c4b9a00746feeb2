"""RL (mirrors ``fpyv_tpu.rl``): GAE and the PPO learner, SAC over the
device replay, and the evolutionary searches."""

from fpyv_tpu_torch.rl.gae import compute_gae  # noqa: F401
from fpyv_tpu_torch.rl.ppo import PpoConfig, PpoState, Transition, make_ppo, scan_train  # noqa: F401
from fpyv_tpu_torch.rl.sac import SacConfig, SacState, make_sac  # noqa: F401
from fpyv_tpu_torch.rl.replay import ReplayBuffer, replay_init  # noqa: F401
from fpyv_tpu_torch.rl.es import make_policy_es, monte_carlo_search, policy_es  # noqa: F401
