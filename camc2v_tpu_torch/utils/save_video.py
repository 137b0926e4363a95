"""Media output: the per-video evaluation contract + grid logging
(`camc2v_tpu/utils/save_video.py`).

reference: CamContextI2V/utils/save_video.py:65-253. The evaluation pipeline
consumes, per generated video, a directory:
    <name>/generated.mp4
    <name>/ground_truth.mp4
    <name>/camera_data.npy
    <name>/captions.txt
    <name>/context_<j>.png        (one per context frame)
Videos are written by `data/video_io.py::write_video`: `.mp4` through
OpenCV where it is installed, else `.npz` (frames uint8, fps) under the same
stem (`video_file`). The PNGs are written without OpenCV
(`data/image_io.py::write_png`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from camc2v_tpu_torch.data.image_io import write_png
from camc2v_tpu_torch.data.video_io import write_video


def video_file(stem: str) -> str:
    """`<stem>.mp4` where OpenCV can encode it, else `<stem>.npz`."""
    try:
        import cv2  # noqa: F401
    except ImportError:
        return stem + ".npz"
    return stem + ".mp4"


def generated_exists(vdir: str) -> bool:
    """Whether a per-video directory holds its generated video (either file)."""
    return any(os.path.exists(os.path.join(vdir, "generated" + ext)) for ext in (".mp4", ".npz"))


def to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1,1] float (T, H, W, 3) -> uint8."""
    return np.clip((np.asarray(video, np.float32) + 1.0) / 2.0 * 255.0, 0, 255).astype(np.uint8)


def log_evaluation(
    out_dir: str,
    name: str,
    generated: np.ndarray,
    ground_truth: Optional[np.ndarray] = None,
    camera_data: Optional[np.ndarray] = None,
    caption: Optional[str] = None,
    context_frames: Optional[np.ndarray] = None,
    fps: float = 8.0,
) -> str:
    """Write one per-video directory (inputs are [-1,1] float, (T, H, W, 3))."""
    vdir = os.path.join(out_dir, name)
    os.makedirs(vdir, exist_ok=True)
    write_video(video_file(os.path.join(vdir, "generated")), to_uint8(generated), fps)
    if ground_truth is not None:
        write_video(video_file(os.path.join(vdir, "ground_truth")), to_uint8(ground_truth), fps)
    if camera_data is not None:
        np.save(os.path.join(vdir, "camera_data.npy"), np.asarray(camera_data))
    if caption is not None:
        with open(os.path.join(vdir, "captions.txt"), "w") as f:
            f.write(caption + "\n")
    if context_frames is not None:
        for j, frame in enumerate(np.asarray(context_frames)):
            write_png(os.path.join(vdir, f"context_{j}.png"), to_uint8(frame[None])[0])
    return vdir


def save_grid(path_stem: str, videos: np.ndarray, fps: float = 8.0, n_cols: int = 4) -> str:
    """(B, T, H, W, 3) [-1,1] -> one tiled grid video (reference log_local)
    at `video_file(path_stem)`; returns its path."""
    b, t, h, w, c = videos.shape
    n_cols = min(n_cols, b)
    n_rows = (b + n_cols - 1) // n_cols
    grid = np.zeros((t, n_rows * h, n_cols * w, c), np.float32) - 1.0
    for i in range(b):
        r, col = divmod(i, n_cols)
        grid[:, r * h : (r + 1) * h, col * w : (col + 1) * w] = videos[i]
    path = video_file(path_stem)
    write_video(path, to_uint8(grid), fps)
    return path
