"""Single-image inference batch builder (demo path; a copy of
`camc2v_tpu/data/single_image.py` on the port's `resize_center_crop`).

reference: CamContextI2V/data/single_image_for_inference.py:34-133 — builds a
model batch from a raw image + pose trajectory: resize-center-crop, default
intrinsics (f = 0.5 * max resized dim), optional second reference image placed
as the final frame (interp mode).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from camc2v_tpu_torch.data.realestate10k import resize_center_crop


class SingleImageForInference:
    def __init__(
        self,
        video_length: int = 16,
        resolution: tuple[int, int] = (256, 256),
        tokenizer=None,
    ):
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.tokenizer = tokenizer

    def get_batch_input(
        self,
        image: np.ndarray,
        caption: str,
        w2c: Optional[np.ndarray] = None,
        intrinsics_norm: Optional[np.ndarray] = None,
        frame_stride: int = 8,
        end_image: Optional[np.ndarray] = None,
    ) -> dict:
        """image: (H, W, 3) uint8 -> numpy batch dict (batch axis included);
        `main.harness.batch_to_device` moves it to the model's device."""
        H, W = self.resolution
        T = self.video_length

        if intrinsics_norm is None:
            # reference default: f = 0.5 * resized dim (single_image_for_inference.py:96-105)
            intrinsics_norm = np.tile(np.array([[0.5, 0.5, 0.5, 0.5]]), (T, 1))
        frames, K = resize_center_crop(image[None], H, W, intrinsics_norm[:1])
        img = (frames[0].astype(np.float32) / 255 - 0.5) * 2
        video = np.tile(img[None], (T, 1, 1, 1))
        if end_image is not None:
            end_frames, _ = resize_center_crop(end_image[None], H, W, intrinsics_norm[:1])
            video[-1] = (end_frames[0].astype(np.float32) / 255 - 0.5) * 2

        if w2c is None:
            w2c = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
        K_full = np.tile(K.astype(np.float32), (T, 1, 1))

        batch = {
            "video": video[None],
            "caption": [caption],
            "frame_stride": np.full((1,), frame_stride, np.int32),
            "RT": w2c[None].astype(np.float32),
            "camera_intrinsics": K_full[None],
        }
        if self.tokenizer is not None:
            batch["caption_tokens"] = np.asarray(self.tokenizer(caption), np.int32)
        return batch
