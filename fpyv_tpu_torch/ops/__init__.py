"""Math and kernels (mirrors ``fpyv_tpu.ops``): rotations, polynomials,
camera math (``camera_ops``), and the fused CUDA kernels with their plain
PyTorch versions (``step_kernel``, ``env_kernel``, ``vision_kernel``,
``policy_kernel``, ``race_kernel``, ``levels_kernel``). Importing this package builds nothing:
kernels compile at first launch (``_build``)."""

from fpyv_tpu_torch.ops import camera_ops, poly, rotations  # noqa: F401
