"""Parser for T-Motor bench test CSVs (thrust/throttle/power curves); the
port's own copy of ``fpyv_tpu.io.motor_csv``.

Reference parity: src/utils/flight_time_calculator.py:16-40
(``read_motor_test_report``). The reference reads with pandas, drops the
header row, strips '%' from Throttle, fixes European ',' decimals in Thrust
and Power, and splits the table into per-motor-variant blocks. Due to a
label-vs-position off-by-one in the reference's split (1-based labels used
as positional slice bounds), each block ends up ending **with and including**
its Throttle==100% row — we reproduce exactly those blocks, without pandas.

For the stock ``config/t_motos_f80_motor_test.csv`` this yields 5 blocks of
11 rows (throttle 50..100% in 5% steps), verified block-for-block against a
pandas run of the reference's steps.
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import List

import numpy as np

COLUMNS = (
    "Type",
    "Propeller",
    "Throttle",
    "Thrust",
    "Voltage",
    "Current",
    "RPM",
    "Power",
    "Efficiency",
    "Temperature",
)


def _to_float(cell: str) -> float:
    """Numeric cell cleanup: strip '%', fix ',' decimal commas; NaN if empty/junk."""
    cell = cell.strip().replace("%", "").replace(",", ".")
    if not cell:
        return math.nan
    try:
        return float(cell)
    except ValueError:
        return math.nan


@dataclass
class MotorTestBlock:
    """One motor-variant block of a bench report (e.g. 'F80 Pro KV1900 / 5055')."""

    motor_name: str
    propeller: str
    throttle: np.ndarray  # percent, float64
    thrust_g: np.ndarray  # grams (single motor), float64
    voltage: np.ndarray
    current: np.ndarray
    rpm: np.ndarray
    power: np.ndarray
    efficiency: np.ndarray


def read_motor_test_report(path) -> List[MotorTestBlock]:
    """Parse a motor bench CSV into per-variant blocks (see module docstring)."""
    rows = []
    with open(path, newline="") as f:
        for raw in csv.reader(f):
            # pad/trim to the 10 known columns
            raw = (list(raw) + [""] * len(COLUMNS))[: len(COLUMNS)]
            rows.append(raw)
    if rows and rows[0][0].strip() == "Type":
        rows = rows[1:]

    blocks: List[MotorTestBlock] = []
    current: list = []
    for raw in rows:
        current.append(raw)
        if _to_float(raw[2]) == 100.0:  # Throttle == 100% closes a block
            blocks.append(_build_block(current))
            current = []
    if current:  # trailing rows with no 100% terminator still form a block
        blocks.append(_build_block(current))
    return blocks


def _build_block(raw_rows) -> MotorTestBlock:
    def col(i):
        return np.array([_to_float(r[i]) for r in raw_rows], dtype=np.float64)

    names = [r[0].strip() for r in raw_rows if r[0].strip()]
    props = [r[1].strip() for r in raw_rows if r[1].strip()]
    return MotorTestBlock(
        motor_name=names[0] if names else "",
        propeller=props[0] if props else "",
        throttle=col(2),
        thrust_g=col(3),
        voltage=col(4),
        current=col(5),
        rpm=col(6),
        power=col(7),
        efficiency=col(8),
    )
