"""Video recording sink: the headless twin of the reference's live windows.

The reference shows its FPV view in a live `cv2.imshow` window
(the reference's src/core/simulator.py:165-166). On display-less hardware
the framework routes the same HUD-overlaid frames through ``frame_sink``
callables (apps/simulator.py); this module provides the sink that encodes
them into a video file, so `cli sim --render 2d --save-video out.mp4`
produces the watchable artifact the live window would have shown.

The port's own copy of ``fpyv_tpu.viz.video``.
"""

from __future__ import annotations

import numpy as np


class VideoWriterSink:
    """frame_sink callable encoding uint8 frames via cv2.VideoWriter.

    Lazily opens the writer on the first frame (size comes from the frame);
    grayscale (H, W) frames are expanded to BGR. Call :meth:`close` (or use
    as a context manager) to finalize the file.
    """

    _FOURCC = {"mp4": "mp4v", "avi": "MJPG", "mkv": "X264"}

    def __init__(self, path: str, fps: float = 60.0):
        self.path = str(path)
        self.fps = float(fps)
        self.frames_written = 0
        self._writer = None

    def __call__(self, frame) -> None:
        import cv2

        frame = np.asarray(frame, np.uint8)
        if frame.ndim == 2:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if self._writer is None:
            ext = self.path.rsplit(".", 1)[-1].lower()
            fourcc = cv2.VideoWriter_fourcc(*self._FOURCC.get(ext, "mp4v"))
            h, w = frame.shape[:2]
            self._writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
            if not self._writer.isOpened():
                raise RuntimeError(f"could not open video writer for {self.path}")
        self._writer.write(frame)
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
