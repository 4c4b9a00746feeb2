"""Neural nets (mirrors ``fpyv_tpu.models``): the minimal functional
modules (``nn``) and the terrain nets, the pixel and state actor-critics,
and SAC's actor and twin critic."""

from fpyv_tpu_torch.models import nn  # noqa: F401
from fpyv_tpu_torch.models.terrain import TerrainNet, terrain_heightmap  # noqa: F401
from fpyv_tpu_torch.models.policy import ActorCritic, PixelActorCritic  # noqa: F401
from fpyv_tpu_torch.models.policy import SquashedGaussianActor, TwinQNetwork  # noqa: F401
