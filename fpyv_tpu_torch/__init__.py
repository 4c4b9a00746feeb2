"""fpyv_tpu_torch — the PyTorch/CUDA port of ``fpyv_tpu`` for NVIDIA Hopper.

The JAX package ``fpyv_tpu`` is the reference; this package reproduces it
module by module in PyTorch and replaces each of its Pallas TPU kernels with
a CUDA kernel written by hand for ``sm_90a``. It imports ``torch`` and
numpy only, never ``jax`` and never a module of ``fpyv_tpu``.

Package map (each module names the ``fpyv_tpu`` module it mirrors):

- :mod:`fpyv_tpu_torch.ops`      — rotations, polynomials, camera math, the
  fused kernels (``step_kernel``, ``env_kernel``, ``vision_kernel``) and
  their build (``_build``)
- :mod:`fpyv_tpu_torch.physics`  — motor curve, SoA world and SDFs,
  collisions, the drone step
- :mod:`fpyv_tpu_torch.world`    — icosphere, world generators, render
  banks, per-env randomized worlds
- :mod:`fpyv_tpu_torch.vision`   — camera rig, splat and raycast renderers
- :mod:`fpyv_tpu_torch.control`, :mod:`fpyv_tpu_torch.sensors` — PID,
  guidance autopilots, UWB range
- :mod:`fpyv_tpu_torch.envs`     — the acro env and the vision env
- :mod:`fpyv_tpu_torch.io`       — config files and motor CSVs
- :mod:`fpyv_tpu_torch.interop`  — state and worlds to and from numpy dicts
  keyed by the JAX package's field names

Entry points run on CUDA unless the caller passes ``device="cpu"``
(:func:`fpyv_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
