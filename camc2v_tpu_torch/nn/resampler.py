"""Perceiver-style image-token resampler (`camc2v_tpu/nn/resampler.py`).

reference: lvdm/modules/encoders/resampler.py:31-165. 16 queries per frame x
16 frames with a per-frame timestep embedding before the output projection.
Its attention scales q and k by d^-1/4 each and does not go through the
attention seam (the same as the JAX module), so it stays plain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.core.schedules import timestep_embedding
from camc2v_tpu_torch.nn.layers import Dense, LayerNormF32


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int, *, dtype=torch.float32):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = LayerNormF32(dim)
        self.norm2 = LayerNormF32(dim)
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Dense(dim, inner * 2, bias=False, dtype=dtype)
        self.to_out = Dense(inner, dim, bias=False, dtype=dtype)

    def forward(self, x, latents):
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        split = lambda t: t.reshape(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)
        qh, kh, vh = split(q), split(k), split(v)
        scale = 1.0 / math.sqrt(math.sqrt(self.dim_head))
        weight = torch.einsum("bhqd,bhkd->bhqk", (qh * scale).float(), (kh * scale).float())
        probs = torch.softmax(weight, dim=-1).to(vh.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs.float(), vh.float()).to(vh.dtype)
        return self.to_out(out.transpose(1, 2).reshape(b, l, -1))


class ResamplerFeedForward(nn.Module):
    """LN -> Linear -> GELU -> Linear, bias-free."""

    def __init__(self, dim: int, mult: int, *, dtype=torch.float32):
        super().__init__()
        self.norm = LayerNormF32(dim)
        self.fc1 = Dense(dim, dim * mult, bias=False, dtype=dtype)
        self.fc2 = Dense(dim * mult, dim, bias=False, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class Resampler(nn.Module):
    """(B, L_in, embedding_dim) -> (B, num_queries * video_length, output_dim)."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64, heads: int = 16,
                 num_queries: int = 8, embedding_dim: int = 768, output_dim: int = 1024, ff_mult: int = 4,
                 video_length: Optional[int] = None, use_timestep_emb: bool = False, *, dtype=torch.float32):
        super().__init__()
        self.dim, self.depth, self.dtype = dim, depth, dtype
        self.video_length, self.use_timestep_emb = video_length, use_timestep_emb
        self.latents = nn.Parameter(torch.empty(1, num_queries * (video_length or 1), dim))
        self.proj_in = Dense(embedding_dim, dim, dtype=dtype)
        for i in range(depth):
            setattr(self, f"attn_{i}", PerceiverAttention(dim, dim_head, heads, dtype=dtype))
            setattr(self, f"ff_{i}", ResamplerFeedForward(dim, ff_mult, dtype=dtype))
        if use_timestep_emb:
            self.temb_fc1 = Dense(dim, dim, dtype=dtype)
            self.temb_fc2 = Dense(dim, dim, dtype=dtype)
        self.proj_out = Dense(dim, output_dim, dtype=dtype)
        self.norm_out = LayerNormF32(output_dim)

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1).to(self.dtype)
        x = self.proj_in(x)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x, latents) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        if self.use_timestep_emb:
            frames = torch.arange(self.video_length, device=x.device)
            t_emb = timestep_embedding(frames, self.dim).to(latents.dtype)
            t_emb = self.temb_fc2(F.silu(self.temb_fc1(t_emb)))
            per_frame = latents.shape[1] // self.video_length
            latents = latents + t_emb.repeat_interleave(per_frame, dim=0)[None]
        return self.norm_out(self.proj_out(latents))
