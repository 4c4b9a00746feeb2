"""FPV HUD overlay on depth frames — parity with the reference's OpenCV loop.

simulator.py:150-163 overlays a target circle, a setpoint circle, and a
text line (distance / speed kph / throttle % / height) on the depth image.
cv2 is optional; without it the text overlay degrades to returning the
raw frame.

The port's own copy of ``fpyv_tpu.viz.hud``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def hud_overlay(
    frame: np.ndarray,  # (H, W) uint8 depth image
    target_pixel: Optional[Tuple[float, float]] = None,
    setpoint_pixel: Optional[Tuple[float, float]] = None,
    dist_to_target: Optional[float] = None,
    speed_ms: Optional[float] = None,
    throttle: Optional[float] = None,  # [-1, 1]
    height_m: Optional[float] = None,
) -> np.ndarray:
    frame = np.asarray(frame).astype(np.uint8).copy()
    try:
        import cv2
    except ImportError:
        return frame

    if target_pixel is not None:
        cv2.circle(frame, tuple(int(v) for v in target_pixel), 10,
                   (255, 255, 255), 1)  # simulator.py:152
    if setpoint_pixel is not None:
        cv2.circle(frame, tuple(int(v) for v in setpoint_pixel), 5,
                   (127, 127, 127), 2)  # simulator.py:154
    parts = []
    if dist_to_target is not None:
        parts.append(f"dist2target: {dist_to_target:.2f} m")
    if speed_ms is not None:
        parts.append(f"velocity: {3.6 * speed_ms:.2f} kph")  # :159
    if throttle is not None:
        parts.append(f"throttle: {100 * (throttle + 1) / 2:.2f} %")  # :161
    if height_m is not None:
        parts.append(f"height: {height_m:.2f} m")
    if parts:
        frame = cv2.putText(frame, ", ".join(parts), (10, 20),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                            cv2.LINE_AA)
    return frame
