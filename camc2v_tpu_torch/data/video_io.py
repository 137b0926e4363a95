"""Video decode/encode on the host (`camc2v_tpu/data/video_io.py`).

Backends, in order:
  1. `.npz` clip files (tests and pre-extracted datasets): a file `foo.npz`
     with array 'frames' (T, H, W, 3) uint8 and scalar 'fps'; always there;
  2. OpenCV `VideoCapture` / `VideoWriter`, imported when a container file
     is opened (OpenCV is optional: without it only `.npz` clips read).
The JAX package's native libav decoder (`native/decode/`) is not ported yet.

All frames are RGB uint8 (T, H, W, 3).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("reading or writing container video needs OpenCV (cv2), which is not installed; "
                          "use .npz clips") from e
    return cv2


class VideoReader:
    """Random-access frame reader."""

    def __init__(self, path: str):
        self.path = path
        self._frames: Optional[np.ndarray] = None
        self._fps: float = 30.0
        self._n = 0
        self._cap = None
        if path.endswith(".npz"):
            data = np.load(path)
            self._frames = data["frames"]
            self._fps = float(data["fps"]) if "fps" in data else 30.0
            self._n = len(self._frames)
            return
        cv2 = _cv2()
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self._cap = cap
        self._fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))

    def __len__(self) -> int:
        return self._n

    @property
    def fps(self) -> float:
        return self._fps

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """(len(indices), H, W, 3) RGB uint8."""
        if self._frames is not None:
            return self._frames[np.asarray(indices)]
        cv2 = _cv2()
        # sorted access is much faster for sequential codecs; the order is restored after
        frames = {}
        for idx in np.asarray(indices)[np.argsort(indices)]:
            self._cap.set(cv2.CAP_PROP_POS_FRAMES, int(idx))
            ok, frame = self._cap.read()
            if not ok:
                raise IOError(f"failed to read frame {idx} of {self.path}")
            frames[int(idx)] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        return np.stack([frames[int(i)] for i in indices])

    def read_all(self) -> np.ndarray:
        return self.get_batch(list(range(self._n)))

    def close(self):
        if self._cap is not None:
            self._cap.release()


def write_video(path: str, frames: np.ndarray, fps: float = 8.0) -> None:
    """frames: (T, H, W, 3) uint8 RGB -> mp4 (OpenCV) or .npz."""
    if path.endswith(".npz"):
        np.savez_compressed(path, frames=frames, fps=fps)
        return
    cv2 = _cv2()
    h, w = frames.shape[1:3]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        raise IOError(f"cannot open video writer: {path}")
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
