"""Checkpointing, timing, tracing, metrics and numerical-health guards
(mirrors ``fpyv_tpu.utils``)."""

from fpyv_tpu_torch.utils.profiling import timeit, Throughput, trace  # noqa: F401
from fpyv_tpu_torch.utils.metrics import MetricsLogger  # noqa: F401
from fpyv_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from fpyv_tpu_torch.utils.debug import assert_finite, finite_mask  # noqa: F401
