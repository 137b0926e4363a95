"""RealEstate10K clip + camera-pose dataset, a copy of
`camc2v_tpu/data/realestate10k.py` held to it by the CPU tests (without the
JAX package's native libav decode pool; OpenCV optional, see
`resize_center_crop`).

The JAX package's rebuild of the reference dataset
(reference: CamContextI2V/data/realestate10k.py:17-380): per-sample pose-txt
parsing, stride sampling with the retry/shrink loop, random clip windows, the
six context-frame sampling strategies, resize-center-crop with intrinsics
rescale, [-1,1] normalisation, invalid-sample resampling, and the
batch-consistent context-count collate.

Outputs use this framework's channels-last layout:
  video:          (T, H, W, 3) float32 in [-1, 1]
  RT:             (T, 4, 4) float32 w2c
  camera_intrinsics: (T, 3, 3) float32 (pixel units of the crop)
  cond_frames:    (N, H, W, 3) float32   (when context strategy active)
  RT_cond:        (N, 4, 4) float32
  caption:        str (plus caption_tokens when a tokenizer is configured)

Pose txt format (reference docstring, realestate10k.py:18-41): line 0 = url,
then one line per frame: timestamp fx fy cx cy k1 k2 r11..r34 (intrinsics
normalised by image dims; pose rows are the 3x4 w2c matrix).
"""

from __future__ import annotations

import json
import os
import random
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from camc2v_tpu_torch.data.video_io import VideoReader


class InvalidSample(Exception):
    """Raised by plan/decode for samples that must be resampled
    (reference: realestate10k.py:156-180 invalid-sample set semantics)."""


def parse_pose_lines(lines: Sequence[str], indices: Optional[Sequence[int]] = None) -> np.ndarray:
    """Pose-file body lines -> (N, 19) float array (ts, fx, fy, cx, cy, k1, k2, 3x4)."""
    arr = np.loadtxt(lines)
    if arr.ndim == 1:
        arr = arr[None]
    if indices is not None:
        arr = arr[np.asarray(indices)]
    return arr.astype(np.float64)


def poses_from_camera_data(camera_data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 19) rows -> (normalized intrinsics (N,4), w2c (N,4,4))."""
    intr = camera_data[:, 1:5]
    pose_3x4 = camera_data[:, 7:].reshape(-1, 3, 4)
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (len(pose_3x4), 1, 1))
    return intr, np.concatenate([pose_3x4, bottom], axis=1)


def choose_frame_stride(
    frame_stride: Union[int, Tuple[int, int]],
    frame_num: int,
    video_length: int,
    rng: random.Random,
) -> tuple[int, int]:
    """(stride, required_frames) with the reference retry/shrink semantics
    (realestate10k.py:186-207)."""
    drop = 0
    while True:
        if isinstance(frame_stride, int):
            stride = max(frame_stride - drop, 1)
        else:
            lo, hi = frame_stride
            stride = rng.randint(lo, hi)
        required = stride * (video_length - 1) + 1
        if frame_num < required:
            if isinstance(frame_stride, int) and frame_num < required * 0.5:
                drop += 1
                continue
            stride = max(frame_num // video_length, 1)
            required = stride * (video_length - 1) + 1
        return stride, required


def sample_clip_indices(
    frame_num: int, video_length: int, stride: int, required: int, rng: random.Random
) -> list[int]:
    """Random clip window (realestate10k.py:209-216)."""
    random_range = frame_num - required
    start = rng.randint(0, random_range) if random_range > 0 else 0
    return [start + stride * i for i in range(video_length)]


def sample_context_indices(
    strategy: str,
    stride: int,
    clip_range: Tuple[int, int],
    video_length: int,
    num_frames: Union[int, Sequence[int]],
    rng: np.random.Generator,
    offset: int = 0,
) -> np.ndarray:
    """The six context-frame strategies (realestate10k.py:313-351)."""
    n = num_frames[-1] if isinstance(num_frames, (list, tuple)) else num_frames
    stride_corrected = True
    if strategy == "random_full":
        pool = np.arange(video_length)
    elif strategy == "random_outside":
        pool = np.concatenate(
            [np.arange(max(clip_range[0] - offset, 0)), np.arange(clip_range[1] + offset, video_length)]
        )
    elif strategy == "random_back":
        pool = np.arange(clip_range[1] + offset, video_length)
    elif strategy == "random_front":
        pool = np.arange(0, clip_range[0] - offset)
    elif strategy == "last":
        stride_corrected = False
        pool = np.array([clip_range[1] + offset])
    elif strategy == "furthest_distance":
        stride_corrected = False
        dist_front = clip_range[0]
        dist_back = video_length - clip_range[1]
        pool = np.zeros(1, dtype=np.int64) if dist_front > dist_back else np.full(1, video_length - 1, dtype=np.int64)
    else:
        raise ValueError(f"unknown context strategy '{strategy}'")
    if stride_corrected and stride >= 0:
        pool = pool[::stride]
    n = min(len(pool), n)
    pool = pool.copy()
    rng.shuffle(pool)
    return pool[:n]


def resize_center_crop(
    frames: np.ndarray, H: int, W: int, intr_norm: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Aspect-preserving resize + centre crop; intrinsics -> crop pixel units.

    frames: (T, h, w, 3) uint8; intr_norm: (T, 4) normalised fx fy cx cy.
    Returns ((T, H, W, 3) uint8, (T, 3, 3) float32).
    reference: realestate10k.py:113-147 — fx,fy scale by the RESIZED dims,
    cx,cy by the CROP dims (the centre crop preserves the principal point).
    """
    t, ori_h, ori_w = frames.shape[:3]
    # truncation (not round) matches the reference exactly:
    # CamContextI2V/data/realestate10k.py:121-129 `int(ori_W * H / ori_H)`
    if ori_w / ori_h > W / H:
        new_h, new_w = H, int(ori_w * H / ori_h)
    else:
        new_h, new_w = int(ori_h * W / ori_w), W
    if (new_h, new_w) == (ori_h, ori_w):
        resized = frames  # already at target scale (native pre-scaled decode)
    else:
        resized = _resize_bilinear(frames, new_h, new_w)
    top = (new_h - H) // 2
    left = (new_w - W) // 2
    cropped = resized[:, top : top + H, left : left + W]

    fx = intr_norm[:, 0] * new_w
    fy = intr_norm[:, 1] * new_h
    cx = intr_norm[:, 2] * W
    cy = intr_norm[:, 3] * H
    K = np.zeros((t, 3, 3), np.float32)
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = fx, fy, cx, cy, 1.0
    return cropped, K


def _resize_bilinear(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """(T, h0, w0, 3) uint8 -> (T, h, w, 3) uint8, bilinear with pixel-centre
    sampling: OpenCV's INTER_LINEAR where OpenCV is installed (the JAX
    package's call), else the same interpolation in PyTorch (agrees with
    OpenCV's fixed-point result within one level)."""
    try:
        import cv2
    except ImportError:
        import torch
        import torch.nn.functional as F

        x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2).float()
        y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False, antialias=False)
        return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()
    return np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in frames])


class RealEstate10K:
    """Map-style dataset; __getitem__ returns a numpy sample dict."""

    def __init__(
        self,
        meta_path: str,
        meta_list: str,
        data_dir: str,
        caption_file: str,
        video_length: int = 16,
        resolution: Sequence[int] = (256, 256),
        frame_stride: Union[int, Sequence[int]] = 1,
        frame_stride_for_condition: int = 0,
        invert_video: bool = False,
        spatial_transform: str = "resize_center_crop",
        additional_cond_frames: str = "none",
        num_additional_cond_frames: Union[int, Sequence[int]] = 0,
        exclude_samples: Sequence[str] = (),
        tokenizer: Optional[Callable[[str], np.ndarray]] = None,
        video_suffix: str = ".mp4",
        seed: Optional[int] = None,
        max_samples: Optional[int] = None,
        pad_context_frames_to: Optional[int] = None,
        **unused,
    ):
        """max_samples caps the dataset (the reference DataModule's
        validation_max_n_samples / test_max_n_samples Subset semantics,
        main/utils_data.py:44-150)."""
        assert spatial_transform in (None, "resize_center_crop")
        self.meta_path = meta_path
        self.data_dir = data_dir
        self.video_length = video_length
        self.resolution = [resolution, resolution] if isinstance(resolution, int) else list(resolution)
        self.frame_stride = tuple(frame_stride) if not isinstance(frame_stride, int) else frame_stride
        self.frame_stride_for_condition = frame_stride_for_condition
        self.invert_video = invert_video
        self.additional_cond_frames = additional_cond_frames
        self.num_additional_cond_frames = (
            list(num_additional_cond_frames)
            if not isinstance(num_additional_cond_frames, int)
            else num_additional_cond_frames
        )
        self.tokenizer = tokenizer
        self.video_suffix = video_suffix
        self.pad_context_frames_to = pad_context_frames_to
        self._rng = random.Random(seed)
        self._nprng = np.random.default_rng(seed)

        with open(meta_list) as f:
            self.metadata = [line.strip() for line in f if line.strip()]
        with open(caption_file) as f:
            self.captions = json.load(f)
        self.invalid_samples = set(exclude_samples)
        if self.invalid_samples:
            self.metadata = [m for m in self.metadata if m not in self.invalid_samples]
        if max_samples is not None:
            self.metadata = self.metadata[:max_samples]

    def __len__(self) -> int:
        return len(self.metadata)

    def get_all_sample_names(self) -> list[str]:
        return list(self.metadata)

    def get_index_by_name(self, name: str) -> Optional[int]:
        try:
            return self.metadata.index(name)
        except ValueError:
            return None

    def _resample(self):
        return self[self._rng.randint(0, len(self) - 1)]

    # ------------------------------------------------------- two-phase fetch
    # __getitem__ = plan() [host metadata, no decode] + finish() [transform].
    # The split lets PrefetchDataLoader run the decode on the C++ DecodePool
    # between the phases (reference analogue: persistent DataLoader workers,
    # main/utils_data.py:44-150).

    def plan(self, index: int) -> dict:
        """Metadata phase: choose clip/context indices + poses. Raises
        InvalidSample for samples that should be resampled."""
        index = index % len(self.metadata)
        name = self.metadata[index]
        if name in self.invalid_samples:
            raise InvalidSample(name)

        cap_key = f"{name}.mp4"
        if cap_key not in self.captions:
            self.invalid_samples.add(name)
            raise InvalidSample(name)
        caption_entry = self.captions[cap_key]
        caption = caption_entry[0] if isinstance(caption_entry, list) else caption_entry

        video_path = os.path.join(self.data_dir, f"{name}{self.video_suffix}")
        if not os.path.exists(video_path):
            raise InvalidSample(name)

        with open(os.path.join(self.meta_path, f"{name}.txt")) as f:
            lines = f.readlines()[1:]
        frame_num = len(lines)

        try:
            reader = VideoReader(video_path)
            n_video_frames = len(reader)
            fps = reader.fps
            reader.close()
        except Exception:
            self.invalid_samples.add(name)
            raise InvalidSample(name)

        stride, required = choose_frame_stride(self.frame_stride, frame_num, self.video_length, self._rng)
        frame_indices = sample_clip_indices(frame_num, self.video_length, stride, required, self._rng)

        camera_data = parse_pose_lines(lines, frame_indices)
        intr_norm, w2c = poses_from_camera_data(camera_data)

        context_indices = None
        w2c_cond = None
        ctx_intr = None
        if self.additional_cond_frames not in (None, "none"):
            context_indices = sample_context_indices(
                self.additional_cond_frames,
                stride,
                (frame_indices[0], frame_indices[-1]),
                n_video_frames,
                self.num_additional_cond_frames,
                self._nprng,
            )
            ctx_camera_data = parse_pose_lines(lines, context_indices)
            ctx_intr = ctx_camera_data[:, 1:5]
            _, w2c_cond = poses_from_camera_data(ctx_camera_data)

        return {
            "name": name,
            "caption": caption,
            "video_path": video_path,
            "fps": fps,
            "stride": stride,
            "frame_indices": list(frame_indices),
            "context_indices": None if context_indices is None else [int(i) for i in context_indices],
            "camera_data": camera_data,
            "intr_norm": intr_norm,
            "w2c": w2c,
            "w2c_cond": w2c_cond,
            "ctx_intr": ctx_intr,
        }

    def decode(self, plan: dict) -> np.ndarray:
        """Synchronous decode of the planned frames (video + context)."""
        indices = list(plan["frame_indices"]) + (plan["context_indices"] or [])
        try:
            reader = VideoReader(plan["video_path"])
            try:
                return reader.get_batch(indices)
            finally:
                reader.close()
        except Exception:
            self.invalid_samples.add(plan["name"])
            raise InvalidSample(plan["name"])

    def finish(self, plan: dict, frames: np.ndarray) -> dict:
        """Transform phase: resize-center-crop + intrinsics rescale + assembly."""
        caption = plan["caption"]
        context_indices = plan["context_indices"]
        camera_data = plan["camera_data"]
        stride = plan["stride"]

        all_intr = plan["intr_norm"] if context_indices is None else np.concatenate(
            [plan["intr_norm"], plan["ctx_intr"]], axis=0
        )
        frames, K_all = resize_center_crop(frames, self.resolution[0], self.resolution[1], all_intr)
        K = K_all[: self.video_length]
        camera_data = camera_data.copy()
        camera_data[:, 1:5] = np.stack([K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2]], axis=-1)

        video = (frames.astype(np.float32) / 255.0 - 0.5) * 2.0

        sample = {
            "video": video[: self.video_length],
            "caption": caption,
            "video_path": plan["video_path"],
            "fps": np.float32(plan["fps"] // max(1, stride)),
            "frame_stride": np.int32(
                stride if self.frame_stride_for_condition == 0 else self.frame_stride_for_condition
            ),
            "RT": plan["w2c"].astype(np.float32),
            "camera_data": camera_data.astype(np.float32),
            "camera_intrinsics": K.astype(np.float32),
        }
        if context_indices is not None:
            sample["cond_frames"] = video[self.video_length :]
            sample["RT_cond"] = plan["w2c_cond"].astype(np.float32)

        if self.invert_video and self._rng.random() > 0.5:
            sample["video"] = sample["video"][::-1].copy()

        if self.tokenizer is not None:
            toks = np.asarray(self.tokenizer(caption), np.int32)
            if toks.ndim == 2:  # tokenizers return (1, L) for a single string
                toks = toks[0]
            sample["caption_tokens"] = toks
        return sample

    def __getitem__(self, index: int) -> dict:
        try:
            plan = self.plan(index)
            frames = self.decode(plan)
            return self.finish(plan, frames)
        except InvalidSample:
            return self._resample()

    # ---------------------------------------------------------------- batch
    def collate(self, samples: list[dict]) -> dict:
        """Batch-consistent context-count subsample + stack.

        reference: realestate10k.py:355-369.
        """
        if self.additional_cond_frames not in (None, "none") and isinstance(
            self.num_additional_cond_frames, list
        ):
            lo, hi = self.num_additional_cond_frames[0], self.num_additional_cond_frames[-1]
            n = self._rng.randint(lo, hi)
            n = min(n, min(s["cond_frames"].shape[0] for s in samples))
            n = max(n, 1)
            for s in samples:
                s["cond_frames"] = s["cond_frames"][:n]
                s["RT_cond"] = s["RT_cond"][:n]
        if self.pad_context_frames_to and samples and "cond_frames" in samples[0]:
            # pad-to-max: every context count compiles ONE program; padded
            # slots (zero frames, identity poses) are neutralised by the
            # cond_frames_valid mask inside the model
            nmax = self.pad_context_frames_to
            for s in samples:
                n = s["cond_frames"].shape[0]
                pad = nmax - n
                if pad > 0:
                    zf = np.zeros((pad, *s["cond_frames"].shape[1:]), s["cond_frames"].dtype)
                    s["cond_frames"] = np.concatenate([s["cond_frames"], zf], axis=0)
                    ident = np.tile(np.eye(4, dtype=s["RT_cond"].dtype), (pad, 1, 1))
                    s["RT_cond"] = np.concatenate([s["RT_cond"], ident], axis=0)
                s["cond_frames_valid"] = (np.arange(nmax) < n)
        out = {}
        for key in samples[0]:
            vals = [s[key] for s in samples]
            if isinstance(vals[0], (str, bytes)):
                out[key] = vals
            else:
                out[key] = np.stack(vals)
        return out


class DataLoader:
    """Epoch iterator with shuffling, collate and threaded prefetch (the
    JAX package's, without its native decode pool):
      * num_workers > 0: worker threads run plan -> decode -> finish ahead of
        the consumer, keeping `prefetch_batches` batches in flight;
      * num_workers == 0: synchronous (deterministic order; tests use this).
    `num_shards`/`shard_index` split the samples between data-parallel ranks.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        num_workers: int = 0,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_workers = num_workers
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_index :: self.num_shards]
        self.epoch += 1
        return order

    def _collate(self, batch):
        return self.dataset.collate(batch) if hasattr(self.dataset, "collate") else batch

    def _fetch_sample(self, idx: int) -> dict:
        """plan -> decode -> finish, with resample-on-invalid retries."""
        if not hasattr(self.dataset, "plan"):
            return self.dataset[int(idx)]
        rng = random.Random((self.seed, self.epoch, int(idx)).__hash__())
        for _ in range(32):
            try:
                plan = self.dataset.plan(int(idx))
                return self.dataset.finish(plan, self.dataset.decode(plan))
            except InvalidSample:
                idx = rng.randint(0, len(self.dataset) - 1)
        raise RuntimeError("32 consecutive invalid samples — dataset looks broken")

    def __iter__(self):
        if self.num_workers <= 0:
            order = self._order()
            batch = []
            for idx in order:
                batch.append(self.dataset[int(idx)])
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._collate(batch)
            return
        yield from self._iter_prefetch()

    def _iter_prefetch(self):
        import collections
        from concurrent.futures import ThreadPoolExecutor

        order = self._order()
        max_inflight = self.batch_size * self.prefetch_batches + self.num_workers
        ex = ThreadPoolExecutor(max_workers=self.num_workers)
        futures = collections.deque()
        it = iter(order.tolist())
        try:
            exhausted = False
            while True:
                while not exhausted and len(futures) < max_inflight:
                    nxt = next(it, None)
                    if nxt is None:
                        exhausted = True
                        break
                    futures.append(ex.submit(self._fetch_sample, int(nxt)))
                if not futures:
                    break
                batch = []
                while futures and len(batch) < self.batch_size:
                    batch.append(futures.popleft().result())
                if len(batch) == self.batch_size or (batch and not self.drop_last):
                    yield self._collate(batch)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def close(self):
        pass
