"""OpenCLIP ViT-H/14 text and image towers (`camc2v_tpu/nn/clip.py`).

* `CLIPTextTower`: causal text transformer, penultimate-layer output then
  ln_final -> (B, 77, 1024).
* `CLIPVisionTower`: ViT returning the full token sequence, no ln_post and
  no projection -> (B, 257, 1280).
* `clip_preprocess`: [-1, 1] frames -> 224x224 bicubic (Keys a = -0.5, the
  kernel widened when downsampling, as `jax.image.resize`) + CLIP
  normalisation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.config import CLIPTextConfig, CLIPVisionConfig
from camc2v_tpu_torch.nn.layers import Conv, Dense, LayerNormF32
from camc2v_tpu_torch.ops.attention import dot_product_attention

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, *, dtype=torch.float32):
        super().__init__()
        self.c_fc = Dense(width, width * 4, dtype=dtype)
        self.c_proj = Dense(width * 4, width, dtype=dtype)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, *, dtype=torch.float32):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj = Dense(width, 3 * width, dtype=dtype)
        self.out_proj = Dense(width, width, dtype=dtype)

    def forward(self, x, causal: bool = False):
        b, l, _ = x.shape
        d = self.width // self.heads
        q, k, v = (t.reshape(b, l, self.heads, d) for t in self.in_proj(x).chunk(3, dim=-1))
        mask = None
        if causal:
            mask = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()[None, None]
        out = dot_product_attention(q, k, v, mask=mask)
        return self.out_proj(out.reshape(b, l, self.width))


class CLIPResBlock(nn.Module):
    def __init__(self, width: int, heads: int, *, dtype=torch.float32):
        super().__init__()
        self.ln_1 = LayerNormF32(width)
        self.attn = CLIPAttention(width, heads, dtype=dtype)
        self.ln_2 = LayerNormF32(width)
        self.mlp = CLIPMLP(width, dtype=dtype)

    def forward(self, x, causal: bool = False):
        x = x + self.attn(self.ln_1(x), causal=causal)
        return x + self.mlp(self.ln_2(x))


class CLIPTextTower(nn.Module):
    """(B, 77) int token ids -> (B, 77, width). With penultimate output the
    last resblock is never run, and has no parameters here."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig(), *, dtype=torch.float32):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.n_run = cfg.layers - (1 if cfg.output_layer == "penultimate" else 0)
        for i in range(self.n_run):
            setattr(self, f"resblock_{i}", CLIPResBlock(cfg.width, cfg.heads, dtype=dtype))
        self.ln_final = LayerNormF32(cfg.width)

    def forward(self, tokens):
        x = self.token_embedding[tokens].to(self.dtype) + self.positional_embedding[None].to(self.dtype)
        for i in range(self.n_run):
            x = getattr(self, f"resblock_{i}")(x, causal=True)
        return self.ln_final(x)


class CLIPVisionTower(nn.Module):
    """(B, 224, 224, 3) preprocessed -> (B, grid^2 + 1, width)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(), *, dtype=torch.float32):
        super().__init__()
        self.config, self.dtype = cfg, dtype
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Conv(3, cfg.width, (cfg.patch_size, cfg.patch_size), stride=cfg.patch_size,
                          padding=(0, 0), bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, cfg.width))
        self.ln_pre = LayerNormF32(cfg.width)
        for i in range(cfg.layers):
            setattr(self, f"resblock_{i}", CLIPResBlock(cfg.width, cfg.heads, dtype=dtype))

    def forward(self, images):
        cfg = self.config
        b = images.shape[0]
        x = self.conv1(images).reshape(b, -1, cfg.width)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding[None].to(self.dtype)
        x = self.ln_pre(x)
        for i in range(cfg.layers):
            x = getattr(self, f"resblock_{i}")(x)
        return x


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of `jax.image.resize(..., 'bicubic')` along
    one axis: Keys cubic, antialiased when downsampling, normalised per
    output sample (jax/_src/image/scale.py::compute_weight_mat)."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(out_size) / f32(in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def clip_preprocess(frames: torch.Tensor) -> torch.Tensor:
    """[-1, 1] (N, H, W, 3) -> CLIP-normalised (N, 224, 224, 3) float32."""
    _, h, w, _ = frames.shape
    wh = torch.from_numpy(_resize_weights(h, 224)).to(frames.device)
    ww = torch.from_numpy(_resize_weights(w, 224)).to(frames.device)
    x = torch.einsum("nhwc,hy,wx->nyxc", frames.float(), wh, ww)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
