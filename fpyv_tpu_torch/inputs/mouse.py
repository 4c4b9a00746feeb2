"""Mouse-drag virtual target: the reference FPV window's only
human-steers-the-autopilot affordance (the reference's
src/core/simulator.py:15-31 ``get_target``).

Semantics replicated exactly: every mouse event updates the virtual target
pixel by an EMA with ``rate`` = 0.1 —

- while the left button is held, the pixel eases toward the cursor:
  ``ix = rate*x + (1-rate)*prev_ix``;
- when released, it recenters toward the image center with the weights
  FLIPPED (``ix = (1-rate)*cx + rate*prev_ix`` — the reference's :29-30
  asymmetry: a slow drag out, a fast snap back).

The update runs on every callback invocation regardless of event type
(the reference's ``if flag / else`` sits outside the event dispatch), so
holding the button and moving drags, and any event while released recenters.

Headless/testing: feed events through :meth:`on_event` directly (a scripted
pixel stream); with a cv2 window, wire :meth:`cv2_callback` via
``cv2.setMouseCallback``.  The simulator consumes :meth:`pixel` as the
guidance target pixel in place of the rendered centroid (the reference's
``target_pixels = np.array([ix, iy])`` path, simulator.py:131).

The port's own copy of ``fpyv_tpu.inputs.mouse``.
"""

from __future__ import annotations

from typing import Tuple


class VirtualTarget:
    """Smoothed, recentering mouse-target state (simulator.py:10-31)."""

    def __init__(self, resolution: Tuple[int, int], rate: float = 0.1):
        # simulator.py:10-11: start at half the camera resolution
        self.cx = resolution[0] / 2.0
        self.cy = resolution[1] / 2.0
        self.rate = float(rate)
        self.ix, self.iy = self.cx, self.cy
        self.prev_ix, self.prev_iy = self.cx, self.cy
        self.flag = False  # left button held

    def on_event(self, event: str, x: float = 0.0, y: float = 0.0) -> None:
        """event: 'down' | 'up' | 'move' (any other string = plain update)."""
        if event == "down":
            self.flag = True
        elif event == "up":
            self.flag = False
        r = self.rate
        if self.flag:
            self.ix = r * x + (1.0 - r) * self.prev_ix
            self.iy = r * y + (1.0 - r) * self.prev_iy
        else:  # recenter: weights flipped (simulator.py:29-30)
            self.ix = (1.0 - r) * self.cx + r * self.prev_ix
            self.iy = (1.0 - r) * self.cy + r * self.prev_iy
        self.prev_ix, self.prev_iy = self.ix, self.iy

    def pixel(self) -> Tuple[float, float]:
        return self.ix, self.iy

    # -- cv2 wiring (display path) ------------------------------------------

    def cv2_callback(self, event, x, y, flags, param) -> None:
        """Signature matches cv2.setMouseCallback handlers."""
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN:
            self.on_event("down", x, y)
        elif event == cv2.EVENT_LBUTTONUP:
            self.on_event("up", x, y)
        else:
            self.on_event("move", x, y)
