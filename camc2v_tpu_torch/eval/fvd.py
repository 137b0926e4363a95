"""Fréchet Video Distance: the I3D feature network and Fréchet statistics
(`camc2v_tpu/eval/fvd.py`).

  * `InceptionI3D`: the Kinetics-400 I3D as `nn.Module`s over the JAX
    package's channels-last (B, T, H, W, 3) input in [-1, 1]. Convolutions
    and max pools pad as the JAX "SAME" does: `total = max((ceil(n/s) - 1)
    s + k - n, 0)`, `total // 2` before and the rest after (with -inf for
    the pools), so a stride-2 layer at an even size pads one more after
    than before. BatchNorm always uses its running statistics (eps 1e-3);
    only the logits head has a bias;
  * `gaussian_stats` / `frechet_distance`: a numpy/scipy copy (`sqrtm`
    called without the `disp` flag that SciPy 1.18 drops);
  * `FVDScorer`: the JAX scorer's `.npz` format (a `variables` entry holding
    the JAX `params` and `batch_stats` collections, written by
    `tools/convert_i3d_weights.py`) loaded by
    `utils/weights.py::load_i3d_variables`, batches of 8, and the bilinear
    resize to 224 of `jax.image.resize` (antialiased when it shrinks) as two
    products with its weight matrices. The network runs in f32 with TF32
    off on the device it is given.
Without the converted weights the scorer raises: FVD on random features
means nothing. `init_i3d` seeds a network for running without them.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def same_pads(sizes, kernel, stride) -> list[int]:
    """The JAX "SAME" padding of each axis as `F.pad`'s flat list (last axis
    first, (before, after) each)."""
    pads = []
    for n, k, s in zip(sizes, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return [p for pair in reversed(pads) for p in pair]


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    """`nn.max_pool(..., padding="SAME")` on (B, C, T, H, W): -inf pads."""
    x = F.pad(x, same_pads(x.shape[2:], kernel, stride), value=-math.inf)
    return F.max_pool3d(x, kernel, stride)


class BatchNorm(nn.Module):
    """Inference BatchNorm on (B, C, ...) with running statistics, eps 1e-3
    (the JAX `BatchNorm(use_running_average=True)`)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)


class Unit3D(nn.Module):
    """Conv3D (SAME) + BN + ReLU, the I3D building block, on (B, C, T, H, W)."""

    def __init__(self, in_channels: int, out_channels: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True):
        super().__init__()
        self.kernel, self.stride, self.activation = tuple(kernel), tuple(stride), activation
        self.conv = nn.Conv3d(in_channels, out_channels, self.kernel, self.stride, bias=not use_bn)
        self.bn = BatchNorm(out_channels) if use_bn else None

    def forward(self, x):
        x = self.conv(F.pad(x, same_pads(x.shape[2:], self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    """I3D inception module: 1x1 / 3x3 / 3x3(b) / pool-proj branches."""

    def __init__(self, in_channels: int, channels: tuple[int, int, int, int, int, int]):
        super().__init__()
        c = channels
        self.out_channels = c[0] + c[2] + c[4] + c[5]
        self.b0 = Unit3D(in_channels, c[0])
        self.b1a = Unit3D(in_channels, c[1])
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3))
        self.b2a = Unit3D(in_channels, c[3])
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3))
        self.b3b = Unit3D(in_channels, c[5])

    def forward(self, x):
        b3 = self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)), b3], dim=1)


_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)), ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
          ("Mixed_4b", (192, 96, 208, 16, 48, 64)), ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
          ("Mixed_4d", (128, 128, 256, 24, 64, 64)), ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
          ("Mixed_4f", (256, 160, 320, 32, 128, 128)), ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
# the max pools (kernel = stride) before these blocks
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)), "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3D(nn.Module):
    """Kinetics-400 I3D. Input: (B, T, H, W, 3) in [-1, 1]; T >= 9, H = W = 224.

    `features='logits'` -> (B, 400) pre-softmax logits (videogpt-FVD variant);
    `features='pool'`   -> (B, 1024) average-pooled features (stylegan variant).
    Submodules carry the JAX names (`Conv3d_1a_7x7`, `Mixed_3b.b1b`, `logits`).
    """

    def __init__(self, num_classes: int = 400, features: str = "logits"):
        super().__init__()
        if features not in ("logits", "pool"):
            raise ValueError(f"features: 'logits' or 'pool', not {features!r}")
        self.features = features
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        c = 192
        for name, channels in _MIXED:
            block = InceptionBlock(c, channels)
            self.add_module(name, block)
            c = block.out_channels
        self.logits = Unit3D(c, num_classes, use_bn=False, activation=False)

    def forward(self, x):
        x = x.permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _MIXED:
            if name in _POOL_BEFORE:
                x = max_pool_same(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        pooled = x.mean(dim=(2, 3, 4))
        if self.features == "pool":
            return pooled
        return self.logits(pooled[:, :, None, None, None])[:, :, 0, 0, 0]


@torch.no_grad()
def init_i3d(model: InceptionI3D, generator: torch.Generator) -> InceptionI3D:
    """Seeded weights for running without the pretrained file (the FVD value
    then means nothing): kernels N(0, 2/fan_in), BN scale U(0.5, 1.5), bias
    N(0, 0.1), running mean N(0, 0.1), running var U(0.5, 1.5); the logits
    bias N(0, 0.1). Every BN value is off its 0/1 init, so a statistic that
    is not carried over shows."""
    for m in model.modules():
        if isinstance(m, nn.Conv3d):
            fan_in = math.prod(m.weight.shape[1:])
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.shape, generator=generator) * 0.1)
        elif isinstance(m, BatchNorm):
            n = m.weight.shape
            m.weight.copy_(torch.rand(n, generator=generator) + 0.5)
            m.bias.copy_(torch.randn(n, generator=generator) * 0.1)
            m.running_mean.copy_(torch.randn(n, generator=generator) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=generator) + 0.5)
    return model


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of `jax.image.resize`'s bilinear rule along one
    axis (`scale_and_translate`: a triangle kernel widened by n_in / n_out
    when it shrinks, normalised per output sample, half-pixel centres),
    computed in float32 as JAX computes them: the sample positions' rounding
    moves the weights by ~1e-5, which f64 weights would not share."""
    f32 = np.float32
    inv_scale = f32(n_in / n_out)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps), w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).T


def resize_224(videos: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B, T, 224, 224, C) as `jax.image.resize(...,
    "bilinear")` does: each of H and W that differs from 224 contracted
    with its weight matrix, summed in f64, returned in the input's dtype."""
    x = videos.to(torch.float64)
    for axis in (2, 3):
        if x.shape[axis] != 224:
            w = torch.from_numpy(_resize_matrix(x.shape[axis], 224)).to(x.device, torch.float64)
            x = torch.movedim(torch.tensordot(x, w, dims=([axis], [1])), -1, axis)
    return x.to(videos.dtype)


def _no_tf32():
    """cuDNN with TF32 off for the block, its other flags as they are (the
    convolutions then compute in f32, as the JAX features do)."""
    c = torch.backends.cudnn
    return c.flags(enabled=c.enabled, benchmark=c.benchmark, deterministic=c.deterministic, allow_tf32=False)


def gaussian_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """FD = |mu1-mu2|^2 + Tr(S1 + S2 - 2 (S1 S2)^{1/2})."""
    diff = mu1 - mu2
    # sqrtm of S1 @ S2 via scipy (symmetrised fallback on numerical failure);
    # without `disp`, which newer SciPy no longer takes
    from scipy import linalg

    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def write_i3d_weights(path: str, variables: dict) -> None:
    """A JAX variables dict in the converter's `.npz` format."""
    np.savez_compressed(path, variables=np.asarray(variables, dtype=object))


class FVDScorer:
    """End-to-end FVD over [-1,1] (N, T, H, W, 3) video arrays, the network
    on `device` (the card by default; without CUDA that raises unless the
    caller passes device="cpu")."""

    def __init__(self, weights_path: Optional[str] = None, variant: str = "videogpt", device="cuda"):
        from camc2v_tpu_torch.eval.video_metrics import metric_device
        from camc2v_tpu_torch.utils.weights import load_i3d_variables

        self.variant = variant
        self.device = metric_device(device, "FVDScorer")
        self.model = None
        weights_path = weights_path or os.environ.get("I3D_WEIGHTS_PATH")
        if weights_path and os.path.exists(weights_path):
            archive = np.load(weights_path, allow_pickle=True)
            if "variables" not in getattr(archive, "files", []):
                raise ValueError(
                    f"{weights_path} is not a converted I3D checkpoint (missing "
                    "'variables' entry) — produce one with tools/convert_i3d_weights.py"
                )
            variables = dict(archive["variables"].item())
            if "params" not in variables:
                raise ValueError(
                    f"{weights_path}: 'variables' lacks a 'params' collection — "
                    "wrong or corrupted conversion"
                )
            model = InceptionI3D(features="logits" if variant == "videogpt" else "pool")
            load_i3d_variables(model, variables)
            self.model = model.to(self.device).eval()

    @torch.no_grad()
    def extract_features(self, videos: np.ndarray, batch_size: int = 8) -> np.ndarray:
        if self.model is None:
            raise FileNotFoundError(
                "I3D weights not found — set I3D_WEIGHTS_PATH to a converted "
                "checkpoint (see eval/fvd.py docstring); FVD without pretrained "
                "features is meaningless."
            )
        feats = []
        with _no_tf32():
            for i in range(0, len(videos), batch_size):
                batch = torch.as_tensor(np.asarray(videos[i: i + batch_size], np.float32), device=self.device)
                if batch.shape[2] != 224:
                    batch = resize_224(batch)
                feats.append(self.model(batch).cpu().numpy())
        return np.concatenate(feats)

    def __call__(self, real: np.ndarray, generated: np.ndarray) -> float:
        f_real = self.extract_features(real)
        f_gen = self.extract_features(generated)
        return frechet_distance(*gaussian_stats(f_real), *gaussian_stats(f_gen))
