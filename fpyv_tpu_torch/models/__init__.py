"""Neural nets for the learners (mirrors ``fpyv_tpu.models``): the pixel
and state actor-critics, and SAC's actor and twin critic."""

from fpyv_tpu_torch.models.policy import PixelActorCritic  # noqa: F401
from fpyv_tpu_torch.models.policy import SquashedGaussianActor, TwinQNetwork  # noqa: F401
