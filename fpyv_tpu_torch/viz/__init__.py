"""Host-side debug visualization (not the observation path); the port's
own copy of ``fpyv_tpu.viz``.

The renderers (:mod:`fpyv_tpu_torch.vision`) produce observation tensors;
this package is the human-facing debug layer: matplotlib 3D world views
(render3d parity), OpenCV HUD overlays (simulator.py:158-163 parity), the
video sink and the position trail. Matplotlib/cv2 imports are deferred so
headless training never pays for them.
"""

from fpyv_tpu_torch.viz import render3d  # noqa: F401
