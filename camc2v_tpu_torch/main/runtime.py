"""Image2Video engine: single image + pose trajectory -> video
(`camc2v_tpu/main/runtime.py`).

reference: CamContextI2V/main/runtime.py:59-394 — the demo/serving engine:
lazy multi-model cache, pose-trajectory pipeline (txt w2c -> c2w, trace-scale
extraction, Bézier speed remap, loop mode, lerp to video_length,
auto-regressive pose extension), auto-regressive chunked video generation
(last generated frame becomes the next chunk's conditioning frame) and video
export. Models are built from their yaml (`config_yaml.
build_model_from_config`) with seeded weights, an existing
`pretrained_checkpoint` imported (`utils/torch_import.py`), and kept on the
device, one per name. Chunk k samples from a generator seeded
`seed + k`. The video is `.mp4` where OpenCV is installed, else `.npz`
(`utils/save_video.py::video_file`).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger("camc2v")


def load_trajectory_txt(path: str) -> np.ndarray:
    """Pose txt (reference camera_poses/*.txt format: per-line 3x4 or RealEstate
    rows) -> (F, 4, 4) w2c."""
    arr = np.loadtxt(path)
    if arr.ndim == 1:
        arr = arr[None]
    if arr.shape[1] == 19:  # RealEstate rows: ts + intrinsics + 3x4
        rt34 = arr[:, 7:].reshape(-1, 3, 4)
    elif arr.shape[1] == 12:
        rt34 = arr.reshape(-1, 3, 4)
    else:
        raise ValueError(f"unrecognised trajectory format: {arr.shape}")
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (len(rt34), 1, 1))
    return np.concatenate([rt34, bottom], axis=1)


class Image2Video:
    """Lazy multi-model generation engine."""

    def __init__(
        self,
        model_configs: dict[str, str],
        *,
        result_dir: str = "results/demo",
        video_length: int = 16,
        resolution: tuple[int, int] = (256, 256),
        tokenizer=None,
        dtype=torch.bfloat16,
        seed: int = 123,
        device="cuda",
    ):
        """model_configs: {model_name: yaml_path}; models are built on
        `device` (the card by default: without CUDA the first build raises
        unless the caller asks for the CPU)."""
        self.model_configs = model_configs
        self.result_dir = result_dir
        self.video_length = video_length
        self.resolution = resolution
        self.seed = seed
        self.dtype = dtype
        self.device = torch.device(device)
        self._models: dict[str, Any] = {}
        # None -> resolved lazily from the first built model's text-tower config
        # (context length / vocab must match the model, as in the reference,
        # where the cond stage owns tokenization: lvdm FrozenOpenCLIPEmbedder)
        self.tokenizer = tokenizer
        os.makedirs(result_dir, exist_ok=True)

    def _get_tokenizer(self, model):
        if self.tokenizer is None:
            from camc2v_tpu_torch.data.tokenizer import HashTokenizer, default_tokenizer

            tcfg = model.config.clip_text
            tok = default_tokenizer(context_length=tcfg.context_length)
            if isinstance(tok, HashTokenizer) and tcfg.vocab_size != tok.vocab_size:
                tok = HashTokenizer(tcfg.vocab_size, tcfg.context_length)
            self.tokenizer = tok
        return self.tokenizer

    def _get_model(self, name: str):
        """Lazy build + checkpoint load (reference: runtime.py:85-137, 203-219)."""
        if name in self._models:
            return self._models[name]
        from camc2v_tpu_torch.config_yaml import build_model_from_config, load_yaml
        from camc2v_tpu_torch.utils.weights import cast_for_inference

        cfg = load_yaml(self.model_configs[name])
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)  # the kernels launch on the current device's stream
        model, pretrained = build_model_from_config(cfg, device=self.device, seed=self.seed, dtype=self.dtype)
        if pretrained and os.path.exists(pretrained):
            from camc2v_tpu_torch.utils.torch_import import load_reference_checkpoint

            report = load_reference_checkpoint(model, pretrained)
            logger.info(f"[{name}] imported {len(report['mapped'])} tensors")
        self._models[name] = cast_for_inference(model.eval(), self.dtype)
        return self._models[name]

    def prepare_trajectory(
        self,
        w2c: np.ndarray,
        *,
        trace_extract_ratio: float = 1.0,
        bezier_coef_a: Optional[float] = None,
        bezier_coef_b: Optional[float] = None,
        loop: bool = False,
        num_chunks: int = 1,
    ) -> np.ndarray:
        """Trajectory pipeline -> (num_chunks*video_length, 4, 4) c2w.

        reference: runtime.py:168-201.
        """
        from camc2v_tpu_torch.camera.trajectory import (
            camera_pose_lerp,
            camera_pose_lerp_bezier,
            extend_trajectory_autoregressive,
        )

        c2w = np.linalg.inv(w2c)
        if trace_extract_ratio < 1.0:
            c2w = c2w[: max(2, int(len(c2w) * trace_extract_ratio))]
        if loop:
            c2w = np.concatenate([c2w, c2w[::-1]], axis=0)
        if num_chunks > 1:
            c2w = extend_trajectory_autoregressive(c2w, num_chunks)
        total = self.video_length * num_chunks
        if bezier_coef_a is not None or bezier_coef_b is not None:
            return camera_pose_lerp_bezier(c2w, total, bezier_coef_a, bezier_coef_b)
        return camera_pose_lerp(c2w, total)

    def get_image(
        self,
        model_name: str,
        image: np.ndarray,
        prompt: str,
        *,
        trajectory: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
        context_frames: Optional[np.ndarray] = None,
        context_w2c: Optional[np.ndarray] = None,
        num_chunks: int = 1,
        frame_stride: int = 8,
        ddim_steps: int = 25,
        sampler: str = "ddim",
        guidance_scale: float = 7.5,
        cfg_interval: Optional[tuple] = None,
        camera_cfg: float = 1.0,
        trace_scale_factor: float = 1.0,
        save_name: Optional[str] = None,
        **traj_kwargs,
    ) -> str:
        """Generate (auto-regressively for num_chunks>1) and save the video;
        returns its path.

        reference: runtime.py:139-346.
        """
        from camc2v_tpu_torch.data.realestate10k import resize_center_crop
        from camc2v_tpu_torch.data.video_io import write_video
        from camc2v_tpu_torch.main.harness import batch_to_device
        from camc2v_tpu_torch.utils.save_video import to_uint8, video_file

        model = self._get_model(model_name)
        H, W = self.resolution
        T = self.video_length

        if image.dtype != np.uint8:
            image = np.clip((image.astype(np.float32) + 1) / 2 * 255, 0, 255).astype(np.uint8)
        if intrinsics is None:
            intr_norm = np.tile(np.array([[0.5 * max(H, W) / W, 0.5 * max(H, W) / H, 0.5, 0.5]]), (T, 1))
        else:
            intr_norm = intrinsics
        frames_resized, K = resize_center_crop(image[None], H, W, intr_norm[:1])
        img = (frames_resized[0].astype(np.float32) / 255 - 0.5) * 2
        K = np.tile(K, (T, 1, 1))

        if trajectory is None:
            c2w_all = np.tile(np.eye(4), (T * num_chunks, 1, 1))
        else:
            c2w_all = self.prepare_trajectory(trajectory, num_chunks=num_chunks, **traj_kwargs)

        clips = []
        cond_image = img
        for chunk in range(num_chunks):
            c2w = c2w_all[chunk * T : (chunk + 1) * T]
            batch = {
                "video": np.tile(cond_image[None], (T, 1, 1, 1))[None],
                "caption_tokens": np.asarray(self._get_tokenizer(model)(prompt), np.int32),
                "frame_stride": np.full((1,), frame_stride, np.int32),
                "camera_intrinsics": K.astype(np.float32)[None],
                "RT": np.linalg.inv(c2w).astype(np.float32)[None],
            }
            if context_frames is not None:
                batch["cond_frames"] = np.asarray(context_frames, np.float32)[None]
                rt_cond = context_w2c if context_w2c is not None else np.tile(np.eye(4), (len(context_frames), 1, 1))
                batch["RT_cond"] = np.asarray(rt_cond, np.float32)[None]
            out = model.sample(
                batch_to_device(batch, self.device),
                generator=torch.Generator(device=self.device).manual_seed(self.seed + chunk),
                ddim_steps=ddim_steps,
                sampler=sampler,
                guidance_scale=guidance_scale,
                cfg_interval=cfg_interval,
                camera_cfg=camera_cfg,
                timestep_spacing="uniform_trailing",
                guidance_rescale=0.7,
                trace_scale_factor=trace_scale_factor,
            )
            clip = out[0].float().cpu().numpy()
            clips.append(clip if chunk == 0 else clip[1:])
            cond_image = clip[-1]  # last frame conditions the next chunk

        video_out = np.concatenate(clips, axis=0)
        name = save_name or f"{model_name}_{abs(hash(prompt)) % 10**8}"
        path = video_file(os.path.join(self.result_dir, name))
        write_video(path, to_uint8(video_out), fps=8)
        logger.info(f"[runtime] wrote {path}")
        return path
