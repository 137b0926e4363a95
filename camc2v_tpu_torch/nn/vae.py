"""AutoencoderKL first stage (`camc2v_tpu/nn/vae.py`), channels-last images.

Frame-wise 2D conv encoder/decoder with ch_mult (1, 2, 4, 4), mid-block
single-head attention, double_z moments. GroupNorms use eps 1e-6. The
mid-block attention (D = C = 512 at full size) runs the plain attention twin
on the card: K2 takes head dims up to 128 (see `ops/attention.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.config import VAEConfig
from camc2v_tpu_torch.nn.layers import Conv, GroupNorm32, upsample_nearest2x
from camc2v_tpu_torch.ops.attention import attention_merged_heads


class AEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, *, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv(in_ch, out_ch, (3, 3), dtype=dtype)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv(out_ch, out_ch, (3, 3), dtype=dtype)
        self.nin_shortcut = Conv(in_ch, out_ch, (1, 1), dtype=dtype) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AEAttnBlock(nn.Module):
    """Single-head spatial self-attention with 1x1-conv projections."""

    def __init__(self, ch: int, *, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(ch, eps=1e-6)
        self.q = Conv(ch, ch, (1, 1), dtype=dtype)
        self.k = Conv(ch, ch, (1, 1), dtype=dtype)
        self.v = Conv(ch, ch, (1, 1), dtype=dtype)
        self.proj_out = Conv(ch, ch, (1, 1), dtype=dtype)

    def forward(self, x):
        n, h, w, c = x.shape
        hn = self.norm(x)
        q, k, v = (m(hn).reshape(n, h * w, c) for m in (self.q, self.k, self.v))
        out = attention_merged_heads(q, k, v, num_heads=1)
        return x + self.proj_out(out.reshape(n, h, w, c))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.conv_in = Conv(cfg.in_channels, cfg.ch, (3, 3), dtype=dtype)
        ch = cfg.ch
        curr_res = cfg.resolution
        self.layout: list[str] = []
        for i, mult in enumerate(cfg.ch_mult):
            for j in range(cfg.num_res_blocks):
                self._add(f"down_{i}_block_{j}", AEResnetBlock(ch, cfg.ch * mult, dtype=dtype))
                ch = cfg.ch * mult
                if curr_res in cfg.attn_resolutions:
                    self._add(f"down_{i}_attn_{j}", AEAttnBlock(ch, dtype=dtype))
            if i != len(cfg.ch_mult) - 1:
                # asymmetric (0, 1) pad then a VALID stride-2 conv (reference Downsample)
                self._add(f"down_{i}_downsample", Conv(ch, ch, (3, 3), stride=2, padding=(0, 0), dtype=dtype))
                curr_res //= 2
        self.mid_block_1 = AEResnetBlock(ch, ch, dtype=dtype)
        self.mid_attn_1 = AEAttnBlock(ch, dtype=dtype)
        self.mid_block_2 = AEResnetBlock(ch, ch, dtype=dtype)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels, (3, 3), dtype=dtype)

    def _add(self, name, module):
        self.add_module(name, module)
        self.layout.append(name)

    def forward(self, x):
        h = self.conv_in(x)
        for name in self.layout:
            if name.endswith("_downsample"):
                h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = getattr(self, name)(h)
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, dtype=torch.float32):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, block_in, (3, 3), dtype=dtype)
        self.mid_block_1 = AEResnetBlock(block_in, block_in, dtype=dtype)
        self.mid_attn_1 = AEAttnBlock(block_in, dtype=dtype)
        self.mid_block_2 = AEResnetBlock(block_in, block_in, dtype=dtype)
        self.layout: list[str] = []
        ch = block_in
        for i, mult in reversed(list(enumerate(cfg.ch_mult))):
            for j in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{i}_block_{j}", AEResnetBlock(ch, cfg.ch * mult, dtype=dtype))
                self.layout.append(f"up_{i}_block_{j}")
                ch = cfg.ch * mult
            if i != 0:
                self.add_module(f"up_{i}_upsample", Conv(ch, ch, (3, 3), dtype=dtype))
                self.layout.append(f"up_{i}_upsample")
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, cfg.out_ch, (3, 3), dtype=dtype)

    def forward(self, z):
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for name in self.layout:
            if name.endswith("_upsample"):
                h = upsample_nearest2x(h)
            h = getattr(self, name)(h)
        return self.conv_out(self.norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    """KL autoencoder with quant / post-quant 1x1 convs; `encode` returns the
    moments, `core.distributions` picks mode or sample."""

    def __init__(self, cfg: VAEConfig, *, dtype=torch.float32):
        super().__init__()
        self.config = cfg
        self.encoder = Encoder(cfg, dtype=dtype)
        self.decoder = Decoder(cfg, dtype=dtype)
        z_ch = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = Conv(z_ch, 2 * cfg.embed_dim, (1, 1), dtype=dtype)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, (1, 1), dtype=dtype)

    def encode(self, x):
        return self.quant_conv(self.encoder(x))

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))
