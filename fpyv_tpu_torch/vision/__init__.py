"""FPV camera rig and depth renderers (mirrors ``fpyv_tpu.vision``): the
splat z-buffer and the analytic raycast, and the geometry algorithms
(``vision.geometry``)."""

from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose  # noqa: F401
from fpyv_tpu_torch.vision.renderer import (  # noqa: F401
    prune_objects,
    render_binary_image,
    render_depth_image,
)
