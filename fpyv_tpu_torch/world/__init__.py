"""World construction (mirrors ``fpyv_tpu.world``): icosphere meshes, the
params.yaml world generators, render point banks and per-env randomized
worlds."""

from fpyv_tpu_torch.world.icosphere import icosphere  # noqa: F401
from fpyv_tpu_torch.world.generators import (  # noqa: F401
    WorldSpec,
    build_world,
    cylinder_points,
    gate_corners,
    ground_points,
)
from fpyv_tpu_torch.world.render_bank import (  # noqa: F401
    RenderBank,
    build_dynamic_render_bank,
    build_render_bank,
)
from fpyv_tpu_torch.world.randomize import WorldRanges, sample_worlds  # noqa: F401
