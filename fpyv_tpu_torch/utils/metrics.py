"""Host-side scalar logging (the port's own copy of
``fpyv_tpu.utils.metrics``).

Metrics come out of the training loop as tensors read back once per chunk;
this logger only aggregates and persists them (JSONL, and TensorBoard when
its package is installed).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, print_every: int = 0):
        self.log_dir = Path(log_dir) if log_dir else None
        self.print_every = print_every
        self._file = None
        self._tb = None
        self._n = 0
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.log_dir / "metrics.jsonl", "a")
            try:  # TensorBoard is optional
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(str(self.log_dir))

    def log(self, step: int, metrics: Dict) -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            v = np.asarray(v)
            record[k] = float(v) if v.ndim == 0 else v.mean().item()
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb:
            for k, v in record.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)
        self._n += 1
        if self.print_every and self._n % self.print_every == 0:
            print({k: round(v, 5) for k, v in record.items() if k != "time"})

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
