"""World construction: icosphere meshes and the params.yaml world
generators (mirrors ``fpyv_tpu.world``; render banks and randomized worlds
belong to a later slice)."""

from fpyv_tpu_torch.world.icosphere import icosphere  # noqa: F401
from fpyv_tpu_torch.world.generators import (  # noqa: F401
    WorldSpec,
    build_world,
    cylinder_points,
    gate_corners,
    ground_points,
)
