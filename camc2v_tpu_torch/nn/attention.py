"""Transformer blocks of the 3D UNet (`camc2v_tpu/nn/attention.py`), without
the camera branches (Plücker projection, epipolar attention, MotionCtrl and
CameraCtrl injections), which come with the camera models.

Token tensors are (N, L, C); SpatialTransformer takes (B*T, H, W, C) maps and
TemporalTransformer (B, T, H, W, C) videos. One module tree serves both
paths, as in the JAX package. When `ops.route` picks the kernels (bf16 on
the card), every unmasked self-attention over at most `ta.MAX_T` tokens runs
the fused kernel K3 (with the block's LayerNorm and residual when the whole
attention step fuses), every feed-forward runs K4, and all other attention
goes through the `dot_product_attention` seam (K2). A shape that K3 or K4
cannot take raises in its wrapper; none of the model's does (K3: T = 16,
C in {320, 512, 640, 1280}, head dim 64; K4: C in {320, 512, 640, 1280}).
No K3 or K4 site stays plain on the card in a bf16 model; in a model built
in f32 all of them do, because K3 and K4 are bf16 kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.nn.layers import Dense, GroupNorm32, LayerNormF32
from camc2v_tpu_torch.ops import geglu_ff as gff
from camc2v_tpu_torch.ops import temporal_attention as ta
from camc2v_tpu_torch.ops.attention import dot_product_attention


def _fused_mha_ok(x, dtype) -> bool:
    """K3 takes this self-attention step (the JAX `_ln_mha_fusable` rule,
    with the card in place of the TPU backend)."""
    return ops.route(x, dtype) and x.shape[1] <= ta.MAX_T


class CrossAttention(nn.Module):
    """Multi-head (cross-)attention with the optional dual text/image context
    (reference lvdm/modules/attention.py:44-211): the first `text_context_len`
    context tokens go through to_k/to_v, the rest through to_k_ip/to_v_ip,
    combined as `out + scale * out_ip * (tanh(alpha) + 1)` with the learnable
    gate."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, *, heads: int = 8,
                 dim_head: int = 64, image_cross_attention: bool = False,
                 image_cross_attention_scale: float = 1.0,
                 image_cross_attention_scale_learnable: bool = False, text_context_len: int = 77,
                 dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.text_context_len = text_context_len
        self.image_cross_attention = image_cross_attention
        self.image_cross_attention_scale = image_cross_attention_scale
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)
        self.alpha = None
        if image_cross_attention:
            self.to_k_ip = Dense(ctx_dim, inner, bias=False, dtype=dtype)
            self.to_v_ip = Dense(ctx_dim, inner, bias=False, dtype=dtype)
            if image_cross_attention_scale_learnable:
                self.alpha = nn.Parameter(torch.zeros(()))

    def fused_self_attention(self, x, norm: Optional[LayerNormF32] = None):
        """K3 over (N, T, C): LN (when given) + attention + out-projection,
        plus the residual when the LayerNorm is fused."""
        ln = {} if norm is None else dict(ln_scale=norm.weight, ln_bias=norm.bias, residual=True, eps=norm.eps)
        return ta.fused_temporal_mha(
            x.to(self.dtype).contiguous(), self.to_q.weight, self.to_k.weight, self.to_v.weight,
            self.to_out.weight, self.to_out.bias, heads=self.heads, **ln,
        )

    def forward(self, x, context=None, mask=None, *, context_mask=None):
        self_attn = context is None
        if self_attn and mask is None and _fused_mha_ok(x, self.dtype):
            return self.fused_self_attention(x)
        h, d = self.heads, self.dim_head
        inner = h * d
        ctx = x if self_attn else context
        ctx_img = ctx_img_mask = None
        if self.image_cross_attention and not self_attn:
            ctx, ctx_img = ctx[:, : self.text_context_len], ctx[:, self.text_context_len:]
            if context_mask is not None:
                ctx_img_mask = context_mask[:, self.text_context_len:]
        elif not self_attn:
            ctx = ctx[:, : self.text_context_len]

        split = lambda t: t.reshape(t.shape[0], t.shape[1], h, d)
        q = split(self.to_q(x))
        attn_mask = None if mask is None else mask[:, None]
        out = dot_product_attention(q, split(self.to_k(ctx)), split(self.to_v(ctx)), mask=attn_mask)
        out = out.reshape(out.shape[0], out.shape[1], inner)
        if ctx_img is not None:
            ip_mask = None if ctx_img_mask is None else ctx_img_mask[:, None, None, :]
            out_ip = dot_product_attention(q, split(self.to_k_ip(ctx_img)), split(self.to_v_ip(ctx_img)),
                                           mask=ip_mask)
            out_ip = self.image_cross_attention_scale * out_ip.reshape(out.shape)
            if self.alpha is not None:
                # f32 gate, as in the JAX module: the sum is formed in f32 before to_out
                out = out.float() + out_ip.float() * (torch.tanh(self.alpha.float()) + 1.0)
            else:
                out = out + out_ip
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, *, dtype=torch.float32):
        super().__init__()
        self.proj = Dense(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x):
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * torch.nn.functional.gelu(gate)  # exact erf


class FeedForward(nn.Module):
    """GEGLU feed-forward (reference lvdm/modules/attention.py:431-458)."""

    def __init__(self, dim: int, dim_out: int, *, mult: int = 4, dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        self.geglu = GEGLU(dim, inner, dtype=dtype)
        self.fc2 = Dense(inner, dim_out, dtype=dtype)

    def forward(self, x):
        return self.fc2(self.geglu(x))


class BasicTransformerBlock(nn.Module):
    """attn1 (self) -> attn2 (cross, or self when there is no context) -> FF,
    each pre-LN with a residual."""

    def __init__(self, dim: int, n_heads: int, d_head: int, *, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False, text_context_len: int = 77,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.n_heads, self.d_head, self.dtype = dim, n_heads, d_head, dtype
        self.disable_self_attn = disable_self_attn
        self.norm1 = LayerNormF32(dim)
        self.attn1 = CrossAttention(dim, context_dim if disable_self_attn else None, heads=n_heads,
                                    dim_head=d_head, dtype=dtype)
        self.norm2 = LayerNormF32(dim)
        self.attn2 = CrossAttention(
            dim, context_dim, heads=n_heads, dim_head=d_head,
            image_cross_attention=image_cross_attention,
            image_cross_attention_scale_learnable=image_cross_attention_scale_learnable,
            text_context_len=text_context_len, dtype=dtype,
        )
        self.norm3 = LayerNormF32(dim)
        self.ff = FeedForward(dim, dim, dtype=dtype)

    def forward(self, x, context=None, *, context_mask=None):
        fusable = _fused_mha_ok(x, self.dtype)
        if not self.disable_self_attn and fusable:
            x = self.attn1.fused_self_attention(x, self.norm1)
        else:
            x = self.attn1(self.norm1(x), context=context if self.disable_self_attn else None) + x
        if context is None and fusable:
            x = self.attn2.fused_self_attention(x, self.norm2)
        else:
            x = self.attn2(self.norm2(x), context=context, context_mask=context_mask) + x
        if ops.route(x, self.dtype):
            return gff.fused_ln_geglu_ff(
                x.contiguous(), self.norm3.weight, self.norm3.bias, self.ff.geglu.proj.weight,
                self.ff.geglu.proj.bias, self.ff.fc2.weight, self.ff.fc2.bias, eps=self.norm3.eps,
            )
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Per-frame transformer over H*W tokens: (B*T, H, W, C) -> same
    (reference lvdm/modules/attention.py:256-320, linear projections)."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, *, depth: int = 1,
                 context_dim: Optional[int] = None, disable_self_attn: bool = False,
                 image_cross_attention: bool = False, image_cross_attention_scale_learnable: bool = False,
                 dtype=torch.float32):
        super().__init__()
        inner = n_heads * d_head
        self.depth = depth
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Dense(in_channels, inner, dtype=dtype)
        for i in range(depth):
            setattr(self, f"block_{i}", BasicTransformerBlock(
                inner, n_heads, d_head, context_dim=context_dim, disable_self_attn=disable_self_attn,
                image_cross_attention=image_cross_attention,
                image_cross_attention_scale_learnable=image_cross_attention_scale_learnable, dtype=dtype,
            ))
        self.proj_out = Dense(inner, in_channels, dtype=dtype)

    def forward(self, x, context=None, *, context_mask=None):
        n, hh, ww, c = x.shape
        h = self.proj_in(self.norm(x).reshape(n, hh * ww, c))
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, context=context, context_mask=context_mask)
        return self.proj_out(h).reshape(n, hh, ww, c) + x


class TemporalTransformer(nn.Module):
    """Temporal transformer over T tokens per pixel: (B, T, H, W, C) -> same
    (reference lvdm/modules/attention.py:323-428), self-attention only."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, *, depth: int = 1,
                 only_self_att: bool = True, causal_attention: bool = False,
                 relative_position: bool = False, dtype=torch.float32):
        super().__init__()
        if not only_self_att or causal_attention or relative_position:
            raise NotImplementedError(
                "TemporalTransformer: temporal cross-attention, causal masks and relative "
                "positions are not ported (all off in the shipped configs)")
        inner = n_heads * d_head
        self.depth = depth
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = Dense(in_channels, inner, dtype=dtype)
        for i in range(depth):
            setattr(self, f"block_{i}", BasicTransformerBlock(inner, n_heads, d_head, dtype=dtype))
        self.proj_out = Dense(inner, in_channels, dtype=dtype)

    def forward(self, x):
        b, t, hh, ww, c = x.shape
        h = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, c)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h)
        h = self.proj_out(h).reshape(b, hh, ww, t, c).permute(0, 3, 1, 2, 4)
        return (x + h).contiguous()
