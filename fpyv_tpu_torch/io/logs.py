"""Flight-log readers: Betaflight blackbox + CSV logs.

The reference parses Betaflight/iNav blackbox `.BBL` files via the
``orangebox`` package into a DataFrame (src/utils/log_reader.py:6-20) as
real-flight ground truth for tuning. :func:`blackbox_parser` decodes the
binary format with the from-scratch native C++ decoder
(native/blackbox/fpyv_blackbox.cpp via fpyv_tpu_torch.io.blackbox_native) — no
external dependency — falling back to ``orangebox`` if the native build is
unavailable. :func:`csv_log_reader` covers logs already decoded to CSV
(Betaflight's blackbox_decode output), same field-per-column layout. The
port's own copy of ``fpyv_tpu.io.logs``.
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np


def blackbox_parser(path, log_index: int = 0):
    """Parse a .BBL blackbox log into {field_name: np.ndarray}.

    Uses the native C++ decoder; falls back to the optional ``orangebox``
    package (the reference's dependency) when the native build fails.
    """
    try:
        from fpyv_tpu_torch.io.blackbox_native import decode_blackbox

        return {k: v.astype(np.float64) for k, v in
                decode_blackbox(path, log_index).items()}
    except RuntimeError:
        pass  # native toolchain unavailable — try orangebox

    try:
        from orangebox import Parser  # type: ignore
    except ImportError as e:
        raise ImportError(
            "blackbox_parser needs the native decoder (g++) or the optional "
            "'orangebox' package. Decode the log to CSV with blackbox_decode "
            "and use csv_log_reader instead."
        ) from e

    parser = Parser.load(str(path))
    names = list(parser.field_names)
    rows = []
    for frame in parser.frames():
        row = np.full(len(names), np.nan)
        row[: len(frame.data)] = frame.data
        rows.append(row)
    data = np.asarray(rows) if rows else np.zeros((0, len(names)))
    return {name: data[:, i] for i, name in enumerate(names)}


def csv_log_reader(path) -> Dict[str, np.ndarray]:
    """Read a decoded blackbox CSV (header row of field names) into
    {field_name: float array}; non-numeric cells become NaN."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = [h.strip() for h in next(reader)]
        cols: Dict[str, list] = {h: [] for h in header}
        for row in reader:
            for h, cell in zip(header, row):
                try:
                    cols[h].append(float(cell))
                except ValueError:
                    cols[h].append(float("nan"))
    return {h: np.asarray(v) for h, v in cols.items()}
