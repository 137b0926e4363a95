"""Transformer blocks of the 3D UNet (`camc2v_tpu/nn/attention.py`), with
the camera branches of the temporal blocks, one per `camera_mode`:
`plucker_epipolar` (CamI2V / CamContextI2V: a `pluker_projection` of the
Plücker features plus an `Epipolar` attention, added onto the residual
stream or into attn1's input), `motionctrl` (a `cc_projection` of the
stream and the flattened relative pose after attn1) and `cameractrl` (a
zero-init `cc_projection` of the normed stream plus the level's Plücker
features, added into attn1's input).

Token tensors are (N, L, C); SpatialTransformer takes (B*T, H, W, C) maps and
TemporalTransformer (B, T, H, W, C) videos. One module tree serves both
paths, as in the JAX package. When `ops.route` picks the kernels (bf16 on
the card), every unmasked self-attention over T tokens with T | 64, T <= 32
(`ta.seq_ok`) runs the fused kernel K3 (with the block's LayerNorm and
residual when the whole attention step fuses), every feed-forward runs K4,
and all other attention goes through the `dot_product_attention` seam (K2). A shape that K3 or K4
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
from camc2v_tpu_torch.config import EpipolarConfig
from camc2v_tpu_torch.nn.epipolar import Epipolar
from camc2v_tpu_torch.nn.layers import Dense, GroupNorm32, LayerNormF32
from camc2v_tpu_torch.ops import geglu_ff as gff
from camc2v_tpu_torch.ops import temporal_attention as ta
from camc2v_tpu_torch.ops.attention import dot_product_attention


def _fused_mha_ok(x, dtype) -> bool:
    """K3 takes this self-attention step (the JAX `_ln_mha_fusable` rule,
    with the card in place of the TPU backend and K3's sequence rule,
    `ta.seq_ok`: T divides 64, at most 32, in place of T | 128)."""
    return ops.route(x, dtype) and ta.seq_ok(x.shape[1])


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
    each pre-LN with a residual.

    A temporal block given a camera payload runs its camera branch, after
    `normed = norm1(x)`:
      * `use_camera` and/or `epipolar` (reference modified_forwards.py:
        505-536): Plücker tokens `pl` of this level,
        `z = pluker_projection(normed + pl) + epipolar(normed + pl)`, then
        `x = z + attn1(normed) + x` (add_type 'add_to_main_branch') or
        `x = attn1(normed + z) + x` ('add_into_temporal_attn');
      * camera_mode 'motionctrl' (reference baseline/motionctrl/
        motionctrl_modified_modules.py:184-198): `x = attn1(normed) + x`,
        then `x = cc_projection([x | RT])`, the payload's (B, T, pose_dim)
        relative poses repeated over the block's h*w token rows; a Linear
        of dim + pose_dim -> dim (initialised in the reference to the
        identity on x and zero on RT);
      * camera_mode 'cameractrl' (reference baseline/cameractrl/
        cameractrl_modified_modules.py:230-244): with the level's Plücker
        tokens, `x = attn1(normed + cc_projection(normed + pl)) + x`
        (`cc_projection` zero-initialised in the reference), else
        `x = attn1(normed) + x`.
    attn1 then runs K3 without its LayerNorm, since norm1's output feeds the
    branch too; `cc_projection` is a plain product, as in the JAX package."""

    def __init__(self, dim: int, n_heads: int, d_head: int, *, context_dim: Optional[int] = None,
                 disable_self_attn: bool = False, image_cross_attention: bool = False,
                 image_cross_attention_scale_learnable: bool = False, text_context_len: int = 77,
                 use_camera: bool = False, epipolar: Optional[EpipolarConfig] = None,
                 add_type: str = "add_to_main_branch", camera_mode: str = "plucker_epipolar", pose_dim: int = 12,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.n_heads, self.d_head, self.dtype = dim, n_heads, d_head, dtype
        self.disable_self_attn = disable_self_attn
        if add_type not in ("add_to_main_branch", "add_into_temporal_attn"):
            raise ValueError(f"unknown add_type '{add_type}'")
        if camera_mode not in ("plucker_epipolar", "motionctrl", "cameractrl"):
            raise ValueError(f"unknown camera_mode '{camera_mode}'")
        if camera_mode != "plucker_epipolar" and (use_camera or epipolar is not None):
            raise ValueError(f"camera_mode '{camera_mode}' has no pluker_projection or epipolar attention")
        self.add_type, self.camera_mode = add_type, camera_mode
        self.pluker_projection = Dense(dim, dim, dtype=dtype) if use_camera else None
        self.epipolar = Epipolar(epipolar, dim, n_heads, dtype=dtype) if epipolar is not None else None
        self.cc_projection = None
        if camera_mode != "plucker_epipolar":
            self.cc_projection = Dense(dim + pose_dim if camera_mode == "motionctrl" else dim, dim, dtype=dtype)
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

    def _camera_step(self, x, camera: dict, spatial_hw: tuple[int, int]):
        hh, ww = spatial_hw
        n, t, _ = x.shape
        b = n // (hh * ww)
        normed = self.norm1(x)
        zero_init_x = torch.zeros_like(normed)
        plucker = camera.get("plucker")
        epi_in = normed
        if self.pluker_projection is not None and plucker is not None:
            # (B, T, h, w, C) -> (B*h*w, T, C), the temporal stream's layout
            pl_tokens = plucker.permute(0, 2, 3, 1, 4).reshape(n, t, -1).to(normed.dtype)
            epi_in = normed + pl_tokens
            zero_init_x = zero_init_x + self.pluker_projection(epi_in)
        if self.epipolar is not None:
            feats = epi_in.reshape(b, hh, ww, t, -1).permute(0, 3, 1, 2, 4)
            zero_init_x = zero_init_x + self.epipolar(feats, F=camera.get("F"), prep=camera.get("epi_prep"))
        if self.add_type == "add_to_main_branch":
            return zero_init_x + self.attn1(normed) + x
        return self.attn1(normed + zero_init_x) + x

    def _baseline_step(self, x, camera: dict):
        normed = self.norm1(x)
        if self.camera_mode == "motionctrl":
            x = self.attn1(normed) + x
            rt = camera["RT"]  # (B, T, pose_dim)
            rt_tok = rt.repeat_interleave(x.shape[0] // rt.shape[0], dim=0).to(x.dtype)  # (B*h*w, T, pose_dim)
            return self.cc_projection(torch.cat([x, rt_tok], dim=-1))
        plucker = camera.get("plucker")  # (B, T, h, w, C) of this level, or None
        if plucker is None:
            return self.attn1(normed) + x
        n, t, _ = x.shape
        pl_tokens = plucker.permute(0, 2, 3, 1, 4).reshape(n, t, -1).to(normed.dtype)
        return self.attn1(normed + self.cc_projection(normed + pl_tokens)) + x

    def forward(self, x, context=None, *, context_mask=None, camera: Optional[dict] = None,
                spatial_hw: Optional[tuple[int, int]] = None):
        fusable = _fused_mha_ok(x, self.dtype)
        if camera is not None and self.cc_projection is not None:
            x = self._baseline_step(x, camera)
        elif camera is not None and (self.pluker_projection is not None or self.epipolar is not None):
            x = self._camera_step(x, camera, spatial_hw)
        elif not self.disable_self_attn and fusable:
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
    (reference lvdm/modules/attention.py:323-428 + modified_forwards.py:
    401-450), self-attention only, with the camera branch when configured."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, *, depth: int = 1,
                 only_self_att: bool = True, causal_attention: bool = False,
                 relative_position: bool = False, use_camera: bool = False,
                 epipolar: Optional[EpipolarConfig] = None, add_type: str = "add_to_main_branch",
                 camera_mode: str = "plucker_epipolar", pose_dim: int = 12, dtype=torch.float32):
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
            setattr(self, f"block_{i}", BasicTransformerBlock(
                inner, n_heads, d_head, use_camera=use_camera, epipolar=epipolar, add_type=add_type,
                camera_mode=camera_mode, pose_dim=pose_dim, dtype=dtype))
        self.proj_out = Dense(inner, in_channels, dtype=dtype)

    def forward(self, x, camera: Optional[dict] = None):
        b, t, hh, ww, c = x.shape
        h = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * hh * ww, t, c)
        h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"block_{i}")(h, camera=camera, spatial_hw=(hh, ww))
        h = self.proj_out(h).reshape(b, hh, ww, t, c).permute(0, 3, 1, 2, 4)
        return (x + h).contiguous()
