"""Camera pose encoder: Plücker maps -> per-level feature pyramid
(`camc2v_tpu/camera/pose_encoder.py`; reference
model/modules/camera_pose_encoder.py:295-376).

PixelUnshuffle(8) of the (B, T, H, W, 6) Plücker maps, conv_in, then for
each level `nums_rb` x [PoseResnetBlock -> PoseTemporalAttention over the
frame axis], average-pool downsampling at the first block of every level
after the first. Returns one (B, T, h_l, w_l, C_l) map per level, the UNet's
latent ds {1, 2, 4, 8} pyramid.

The temporal attention goes through the `dot_product_attention` seam with
head dims C_l / 8 = 40, 80, 160 at the flagship widths: the D = 80 level
reaches K2 on the card, D = 40 and D = 160 stay plain (K2's tiles take head
dims that are a multiple of 16 up to 128). Its GEGLU feed-forward stays on
the plain path, as in the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.config import PoseEncoderConfig
from camc2v_tpu_torch.core.schedules import sinusoidal_positional_encoding
from camc2v_tpu_torch.nn.layers import Conv, Dense, LayerNormF32
from camc2v_tpu_torch.ops.attention import dot_product_attention


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(N, H*r, W*r, C) -> (N, H, W, C*r*r), torch's channel order (c, i, j)."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    return x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4).reshape(n, h, w, c * r * r)


class PoseResnetBlock(nn.Module):
    """reference camera_pose_encoder.py:257-291 (ksize 1, sk, avg-pool down)."""

    def __init__(self, in_channels: int, out_channels: int, *, down: bool, ksize: int = 1, sk: bool = True,
                 use_conv: bool = False, dtype=torch.float32):
        super().__init__()
        self.down = down
        self.down_conv = Conv(in_channels, in_channels, (3, 3), stride=2, dtype=dtype) if down and use_conv else None
        ks = (ksize, ksize)
        self.in_conv = Conv(in_channels, out_channels, ks, dtype=dtype) if in_channels != out_channels or not sk \
            else None
        self.block1 = Conv(out_channels, out_channels, (3, 3), dtype=dtype)
        self.block2 = Conv(out_channels, out_channels, ks, dtype=dtype)
        self.skep = Conv(out_channels, out_channels, ks, dtype=dtype) if not sk else None

    def forward(self, x):
        if self.down:
            if self.down_conv is not None:
                x = self.down_conv(x)
            else:
                x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        if self.in_conv is not None:
            x = self.in_conv(x)
        h = self.block2(F.relu(self.block1(x)))
        if self.skep is not None:
            x = self.skep(x)
        return h + x


class PoseTemporalAttention(nn.Module):
    """LayerNorm -> positional encoding -> MHA over the frames -> GEGLU FF,
    each with a residual, over (N, T, C) tokens (reference
    camera_pose_encoder.py:15-158)."""

    def __init__(self, channels: int, heads: int, *, max_len: int = 16, use_pos_encoding: bool = True,
                 dtype=torch.float32):
        super().__init__()
        c = channels
        self.heads, self.max_len, self.use_pos_encoding = heads, max_len, use_pos_encoding
        self.norm = LayerNormF32(c)
        self.to_q = Dense(c, c, bias=False, dtype=dtype)
        self.to_k = Dense(c, c, bias=False, dtype=dtype)
        self.to_v = Dense(c, c, bias=False, dtype=dtype)
        self.to_out = Dense(c, c, dtype=dtype)
        self.ff_norm = LayerNormF32(c)
        self.ff_proj = Dense(c, c * 8, dtype=dtype)
        self.ff_out = Dense(c * 4, c, dtype=dtype)

    def forward(self, x):
        n, t, c = x.shape
        h = self.norm(x)
        if self.use_pos_encoding:
            pe = torch.from_numpy(sinusoidal_positional_encoding(self.max_len, c)[:t]).to(h.device)
            h = h + pe[None].to(h.dtype)
        split = lambda a: a.reshape(n, t, self.heads, c // self.heads)
        out = dot_product_attention(split(self.to_q(h)), split(self.to_k(h)), split(self.to_v(h)))
        x = self.to_out(out.reshape(n, t, c)) + x
        a, gate = self.ff_proj(self.ff_norm(x)).chunk(2, dim=-1)
        return self.ff_out(a * F.gelu(gate)) + x  # exact erf GELU (diffusers GEGLU)


class CameraPoseEncoder(nn.Module):
    """(B, T, H, W, 6) Plücker maps -> tuple of (B, T, h_l, w_l, C_l) features."""

    def __init__(self, config: PoseEncoderConfig = PoseEncoderConfig(), *, dtype=torch.float32):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        self.conv_in = Conv(cfg.cin, cfg.channels[0], (3, 3), dtype=dtype)
        ch_in = cfg.channels[0]
        for i, ch in enumerate(cfg.channels):
            for j in range(cfg.nums_rb):
                # the reference's branch order (camera_pose_encoder.py:320-336):
                # block 0 outputs ch / cf (downsampling when i != 0), the last
                # block (j == nums_rb - 1 > 0) restores ch
                out_dim = int(ch / cfg.compression_factor) if (j == 0 or j != cfg.nums_rb - 1) else ch
                setattr(self, f"level{i}_res{j}", PoseResnetBlock(
                    ch_in, out_dim, down=j == 0 and i != 0, ksize=cfg.ksize, sk=cfg.sk, use_conv=cfg.use_conv,
                    dtype=dtype))
                setattr(self, f"level{i}_attn{j}", PoseTemporalAttention(
                    out_dim, cfg.temporal_attention_nhead, max_len=cfg.temporal_position_encoding_max_len,
                    use_pos_encoding=cfg.temporal_position_encoding, dtype=dtype))
                ch_in = out_dim

    def forward(self, plucker: torch.Tensor) -> tuple[torch.Tensor, ...]:
        cfg = self.config
        b, t, H, W, c = plucker.shape
        x = pixel_unshuffle(plucker.reshape(b * t, H, W, c).to(self.dtype), cfg.downscale_factor)
        x = self.conv_in(x)
        features = []
        for i in range(len(cfg.channels)):
            for j in range(cfg.nums_rb):
                x = getattr(self, f"level{i}_res{j}")(x)
                n, hh, ww, cc = x.shape
                tokens = x.reshape(b, t, hh, ww, cc).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, cc)
                tokens = getattr(self, f"level{i}_attn{j}")(tokens)
                x = tokens.reshape(b, hh, ww, t, cc).permute(0, 3, 1, 2, 4).reshape(n, hh, ww, cc)
            features.append(x.reshape(b, t, hh, ww, cc))
        return tuple(features)
