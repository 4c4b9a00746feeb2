"""Neural nets for the PPO learner (mirrors ``fpyv_tpu.models``): the pixel
actor-critic with the patch torso."""

from fpyv_tpu_torch.models.policy import PixelActorCritic  # noqa: F401
