"""FPV camera rig and depth renderers (mirrors ``fpyv_tpu.vision``): the
splat z-buffer and the analytic raycast. ``vision/geometry.py`` belongs to a
later slice."""

from fpyv_tpu_torch.vision.camera import CameraRig, camera_pose  # noqa: F401
