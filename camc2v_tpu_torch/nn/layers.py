"""Primitive layers (`camc2v_tpu/nn/layers.py`), channels-last.

Parameter names follow the JAX parameter tree so the weight bridge
(`utils/weights.py`) maps `<path>/kernel` to `<path>.weight`:
  Dense.weight (out, in); Conv.weight (out, in, kh, kw) or (out, in, kt, 1, 1);
  GroupNorm32 / LayerNormF32 .weight (JAX `scale`) and .bias, kept f32.

Every layer carries a compute `dtype` like the JAX modules: a Dense or Conv
casts its input and weights to it (a no-op when the weights are stored in
that dtype, as `cast_for_inference` does on the card); norms compute f32
statistics and return the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import groupnorm as gnops
from camc2v_tpu_torch.ops import layernorm as lnops


class Dense(nn.Module):
    """Dense layer of the JAX package: y = x @ W^T + b in `dtype`."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv(nn.Module):
    """Convolution over channels-last maps with torch-style symmetric
    padding ((k-1)//2 per side, JAX `nn/layers.py:187-191`), or explicit
    `padding`. 2-D kernels take (N, H, W, C); 3-D kernels (B, T, H, W, C)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, *, stride: int = 1, padding=None,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.stride = stride
        self.padding = tuple((k - 1) // 2 for k in self.kernel_size) if padding is None else tuple(padding)
        self.dtype = dtype

    def forward(self, x):
        nd = len(self.kernel_size)
        perm_in = (0, nd + 1) + tuple(range(1, nd + 1))
        perm_out = (0,) + tuple(range(2, nd + 2)) + (1,)
        conv = F.conv2d if nd == 2 else F.conv3d
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = conv(x.to(self.dtype).permute(perm_in), self.weight.to(self.dtype), b,
                 stride=self.stride, padding=self.padding)
        return y.permute(perm_out)


def group_norm_site(x: torch.Tensor, groups: int) -> tuple[str, int]:
    """The JAX GroupNorm32's choice of numerics for a site on the card
    (`camc2v_tpu/nn/layers.py:102-146`): ("temporal", 0) where K9's
    single-pass statistics take a 5-D map (`CAMC2V_GN_TEMPORAL=1`),
    ("big4d", s) where they take a 4-D map viewed as (N, s, H/s*W, C)
    (`CAMC2V_GN_BIG4D=1`), else ("two_pass", 0): K1's numerics, which are
    also the plain twin's."""
    temporal, big4d = ops.switch_on("CAMC2V_GN_TEMPORAL"), ops.switch_on("CAMC2V_GN_BIG4D")
    if not (temporal or big4d) or gnops.group_norm_supported(x, groups):
        return "two_pass", 0
    if x.dim() >= 5 and temporal and gnops.group_norm_temporal_supported(x, groups):
        return "temporal", 0
    if x.dim() == 4 and big4d:
        n, h, w, c = x.shape
        for s in range(2, h + 1):
            if h % s == 0 and gnops.group_norm_temporal_supported(x.reshape(n, s, (h // s) * w, c), groups):
                return "big4d", s
    return "two_pass", 0


class GroupNorm32(nn.Module):
    """GroupNorm with f32 statistics and optional fused SiLU; groups become
    gcd(C, 32) when 32 does not divide C (JAX `nn/layers.py:96-99`).

    On the card each site takes the numerics the JAX package gives it
    (`group_norm_site`): K9 (or, inside `ops.plain_twins()`, its plain twin)
    at the sites its switches pick, else the two-pass seam (K1 where
    `ops.route` picks it). The CPU runs the two-pass twin whatever the
    switches, as the JAX package does on its CPU backend."""

    def __init__(self, channels: int, *, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups if channels % num_groups == 0 else math.gcd(channels, num_groups)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, *, silu: bool = False):
        kw = dict(num_groups=self.num_groups, eps=self.eps, silu=silu)
        if x.is_cuda:
            site, s = group_norm_site(x, self.num_groups)
            if site != "two_pass":
                kernel = ops.route(x, takes=(torch.bfloat16, torch.float32))
                xv = x if site == "temporal" else x.reshape(x.shape[0], s, -1, x.shape[-1])
                return gnops.group_norm_fused_temporal(xv, self.weight, self.bias, kernel=kernel,
                                                       **kw).reshape(x.shape)
        return gnops.group_norm(x, self.weight, self.bias, **kw)


class LayerNormF32(nn.Module):
    """LayerNorm with f32 statistics; output cast back to the input dtype.

    With `CAMC2V_LN_FUSED=1`, a tensor on the card at a site that
    `layer_norm_supported` accepts takes K8 (its two-pass twin inside
    `ops.plain_twins()`), as the JAX module does on the TPU; elsewhere the
    library LayerNorm in f32."""

    def __init__(self, channels: int, *, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        if x.is_cuda and ops.switch_on("CAMC2V_LN_FUSED") and lnops.layer_norm_supported(x):
            return lnops.layer_norm_fused(x, self.weight, self.bias, eps=self.eps,
                                          kernel=ops.route(x, takes=(torch.bfloat16, torch.float32)))
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(), self.bias.float(), self.eps)
        return y.to(x.dtype)


class TimestepEmbedMLP(nn.Module):
    """Linear -> SiLU -> Linear (reference openaimodel3d.py:370-382)."""

    def __init__(self, in_features: int, features: int, *, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, features, dtype=dtype)
        self.fc2 = Dense(features, features, dtype=dtype)

    def forward(self, emb):
        return self.fc2(F.silu(self.fc1(emb)))


def upsample_nearest2x(x):
    """(N, H, W, C) -> (N, 2H, 2W, C), nearest (jax.image.resize 'nearest')."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def avg_pool2x(x):
    """(N, H, W, C) -> (N, H/2, W/2, C), 2x2 average (the JAX `avg_pool`, VALID)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Upsample(nn.Module):
    def __init__(self, channels: int, out_channels: int, *, use_conv: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, out_channels, (3, 3), dtype=dtype) if use_conv else None

    def forward(self, x):
        x = upsample_nearest2x(x)
        return self.conv(x) if self.conv is not None else x


class Downsample(nn.Module):
    """Stride-2 3x3 conv, or 2x2 average pooling."""

    def __init__(self, channels: int, out_channels: int, *, use_conv: bool = True, dtype=torch.float32):
        super().__init__()
        self.op = Conv(channels, out_channels, (3, 3), stride=2, dtype=dtype) if use_conv else None

    def forward(self, x):
        return self.op(x) if self.op is not None else avg_pool2x(x)


class TemporalConvBlock(nn.Module):
    """Four (GN+SiLU, conv (3,1,1)) stages on (B, T, H, W, C) plus identity
    (reference openaimodel3d.py:239-279); with `deterministic=False`
    (training) stages 2-4 drop out their conv input."""

    def __init__(self, channels: int, *, dropout: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        for i in range(1, 5):
            setattr(self, f"conv{i}_norm", GroupNorm32(channels))
            setattr(self, f"conv{i}_conv", Conv(channels, channels, (3, 1, 1), dtype=dtype))

    def forward(self, x, *, deterministic: bool = True):
        h = x
        for i in range(1, 5):
            h = getattr(self, f"conv{i}_norm")(h, silu=True)
            if i > 1:
                h = F.dropout(h, self.dropout, not deterministic)
            h = getattr(self, f"conv{i}_conv")(h)
        return x + h


class ResBlock(nn.Module):
    """UNet residual block with timestep-embedding injection, frame-wise on
    (B*T, H, W, C), plus the temporal conv block on the (B, T, ...) view
    (reference openaimodel3d.py:109-236). With `deterministic=False`
    (training) `dropout` applies before out_conv and the temporal conv block
    drops at 0.1, as in the JAX module; the draws come from the global RNG,
    whose state `torch.utils.checkpoint` replays in the recompute. `up` /
    `down` (the UNet's `resblock_updown`) resample the normed input and the
    skip path, 2x nearest or 2x2 average, before in_conv."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, *, dropout: float = 0.0,
                 use_scale_shift_norm: bool = False, use_temporal_conv: bool = False, up: bool = False,
                 down: bool = False, dtype=torch.float32):
        super().__init__()
        self.dropout, self.up, self.down = dropout, up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = Conv(in_ch, out_ch, (3, 3), dtype=dtype)
        self.emb_proj = Dense(emb_dim, 2 * out_ch if use_scale_shift_norm else out_ch, dtype=dtype)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = Conv(out_ch, out_ch, (3, 3), dtype=dtype)
        self.skip = Conv(in_ch, out_ch, (1, 1), dtype=dtype) if in_ch != out_ch else None
        self.temporal_conv = TemporalConvBlock(out_ch, dtype=dtype) if use_temporal_conv else None

    def forward(self, x, emb, *, batch_size: int, deterministic: bool = True):
        h = self.in_norm(x, silu=True)
        if self.up:
            h, x = upsample_nearest2x(h), upsample_nearest2x(x)
        elif self.down:
            h, x = avg_pool2x(h), avg_pool2x(x)
        h = self.in_conv(h)
        emb_out = self.emb_proj(F.silu(emb))[:, None, None, :]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=-1)
            h = F.silu(self.out_norm(h) * (1 + scale) + shift)
        else:
            h = self.out_norm(h + emb_out, silu=True)
        h = self.out_conv(F.dropout(h, self.dropout, not deterministic))
        if self.skip is not None:
            x = self.skip(x)
        h = x + h
        if self.temporal_conv is not None:
            n, hh, ww, c = h.shape
            h = self.temporal_conv(h.reshape(batch_size, n // batch_size, hh, ww, c),
                                   deterministic=deterministic).reshape(n, hh, ww, c)
        return h
