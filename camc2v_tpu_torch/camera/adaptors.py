"""Context-frame latent adaptors of CamContextI2V's latent branch
(`camc2v_tpu/camera/adaptors.py`; reference model/modules/adaptors.py:14-238
and model/modules/utils.py:5-43).

`MultiLatentEpipolarAdaptor`: video_length * num_queries learned queries
cross-attend over the [cond ‖ context] VAE latents through `depth` layers of
epipolar-masked attention + feed-forward, get a per-frame timestep
embedding, and project to the latent width. Its mask is either computed in
K6 from the query lines (`lines`/`geom`/`tile_any`, the generation path at
256x256) or given as a dense (B, Lq, Lk) bool mask, which the attention seam
sends to K2 on the card. Its options, off in the flagship:
  * `output_queries` (a multiple of num_queries): the per-frame query grid
    goes through `upscale_factor - 1` TransposedConvolutions (bilinear 2x +
    3x3 conv) before proj_out;
  * `use_plucker_embedding` with Plücker features passed to the call:
    `plucker_in` projects them, and each layer's queries are the latents
    plus them (`plucker_input_strategy='add'`) or the two concatenated
    ('concat', the attention's queries twice as wide). As in JAX, the
    parameters exist only where features reach the call, and no model
    passes them: a module built with `use_plucker_embedding` and called
    without features computes as one without it, and CamContextI2V builds
    its adaptor without the input (the JAX tree and output);
  * `context_positional_encoding`: each context frame's tokens get the
    sinusoidal embedding of their frame (num_queries wide, one value per
    token) concatenated to every channel (proj_in twice as wide).
`MultiLatentAdaptor` is the unmasked PerceiverAttention variant (no model
builds it, as in JAX).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.core.schedules import timestep_embedding
from camc2v_tpu_torch.nn.epipolar import EpipolarCrossAttention
from camc2v_tpu_torch.nn.layers import Conv, Dense, LayerNormF32
from camc2v_tpu_torch.nn.resampler import PerceiverAttention, ResamplerFeedForward


def cross_normalization(x: torch.Tensor, x_ref: torch.Tensor, axes: tuple[int, ...], eps: float = 1e-5):
    """x re-normalised to x_ref's mean and (unbiased) std over `axes`."""
    mean_ref = x_ref.mean(dim=axes, keepdim=True)
    std_ref = x_ref.std(dim=axes, keepdim=True, correction=1)
    mean_x = x.mean(dim=axes, keepdim=True)
    std_x = x.std(dim=axes, keepdim=True, correction=1)
    return (x - mean_x) * (std_ref / (std_x + eps)) + mean_ref


class TransposedConvolution(nn.Module):
    """Bilinear upsampling by `scale` and a conv (reference adaptors.py:14-34):
    (N, H, W, C) -> (N, scale*H, scale*W, out_ch)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, scale: int = 2, *, dtype=torch.float32):
        super().__init__()
        self.scale = scale
        self.conv = Conv(in_ch, out_ch, (kernel_size, kernel_size), dtype=dtype)

    def forward(self, x):
        # half-pixel centres, the edge sample repeated: jax.image.resize's "bilinear" when upsampling
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=self.scale, mode="bilinear", align_corners=False)
        return self.conv(up.permute(0, 2, 3, 1))


class MultiLatentEpipolarAdaptor(nn.Module):
    """(B, L_ctx, embedding_dim) context latents -> (B, T*output_queries, output_dim).

    plucker_features: build `plucker_in` (plucker_embedding_dim wide) for a
    caller that passes Plücker features; `use_plucker_embedding` alone, as
    in JAX, adds nothing (the module docstring)."""

    def __init__(self, query_dim: int = 512, depth: int = 8, dim_head: int = 64, heads: int = 8,
                 num_queries: int = 1024, output_queries: Optional[int] = None, embedding_dim: int = 768,
                 output_dim: int = 1024, ff_mult: int = 4, num_register_tokens: int = 2, use_mask: bool = True,
                 video_length: Optional[int] = None, use_plucker_embedding: bool = False,
                 plucker_embedding_dim: int = 320, plucker_input_strategy: str = "add",
                 context_positional_encoding: bool = False, timestep_embedding_type: str = "none",
                 timestep_embedding_dim: int = 32, *, plucker_features: bool = False, dtype=torch.float32):
        super().__init__()
        if timestep_embedding_type not in ("none", "sinusoidal", "sinusoidal_embedded"):
            raise ValueError(f"unknown timestep_embedding_type '{timestep_embedding_type}'")
        if plucker_input_strategy not in ("add", "concat"):
            raise ValueError(f"unknown plucker_input_strategy '{plucker_input_strategy}'")
        out_queries = output_queries or num_queries
        if out_queries % num_queries:
            raise ValueError(f"output_queries {out_queries} is not a multiple of num_queries {num_queries}")
        self.depth, self.use_mask, self.dtype = depth, use_mask, dtype
        self.num_queries, self.video_length = num_queries, video_length
        self.plucker_input_strategy = plucker_input_strategy
        self.context_positional_encoding = context_positional_encoding
        self.timestep_embedding_type = timestep_embedding_type
        self.timestep_embedding_dim = timestep_embedding_dim
        total = num_queries * (video_length if video_length is not None else 1)
        self.latents = nn.Parameter(torch.empty(1, total, query_dim))
        self.proj_in = Dense(2 * embedding_dim if context_positional_encoding else embedding_dim, query_dim,
                             dtype=dtype)
        self.plucker_in = None
        if use_plucker_embedding and plucker_features:
            self.plucker_in = Dense(plucker_embedding_dim, query_dim, dtype=dtype)
        attn_in = 2 * query_dim if self.plucker_in is not None and plucker_input_strategy == "concat" else query_dim
        for i in range(depth):
            setattr(self, f"attn_{i}", EpipolarCrossAttention(
                attn_in, query_dim, query_dim, heads=heads, dim_head=dim_head,
                num_register_tokens=num_register_tokens, dtype=dtype))
            setattr(self, f"ff_{i}", ResamplerFeedForward(query_dim, ff_mult, dtype=dtype))
        if timestep_embedding_type == "sinusoidal_embedded":
            self.temb_fc1 = Dense(timestep_embedding_dim, query_dim, dtype=dtype)
            self.temb_fc2 = Dense(query_dim, query_dim, dtype=dtype)
        for u in range(out_queries // num_queries - 1):
            setattr(self, f"upscale_{u}", TransposedConvolution(query_dim, query_dim, dtype=dtype))
        self.upscales = out_queries // num_queries - 1
        self.proj_out = Dense(query_dim, output_dim, dtype=dtype)
        self.norm_out = LayerNormF32(output_dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None, plucker_embedding_features=None, *,
                use_mask: Optional[bool] = None, lines: Optional[torch.Tensor] = None,
                geom: Optional[tuple] = None, tile_any: Optional[torch.Tensor] = None):
        """mask: (B, T*num_queries, L_ctx) bool, used when masking is on and
        no `lines` are given; lines (B, T*num_queries, 1 + n_ctx, 3) with
        geom (1 + n_ctx, h, w, ds, block_k) select the in-kernel mask;
        plucker_embedding_features: (B, T*num_queries, plucker_embedding_dim),
        read where the module has `plucker_in`."""
        video_length = self.video_length if self.video_length is not None else 16
        b = x.shape[0]
        latents = self.latents.expand(b, -1, -1).to(self.dtype)
        if self.context_positional_encoding:
            n = x.shape[1] // self.num_queries
            frames = torch.arange(n, device=x.device)
            pos = timestep_embedding(frames, self.num_queries).reshape(1, -1, 1).to(x.dtype)  # (1, n*nq, 1)
            x = torch.cat([x, pos.expand(b, -1, x.shape[-1])], dim=-1)
        x = self.proj_in(x)
        pl = None
        if self.plucker_in is not None and plucker_embedding_features is not None:
            pl = self.plucker_in(plucker_embedding_features)
        masking = self.use_mask if use_mask is None else use_mask
        kernel = masking and lines is not None
        dense_mask = mask if masking and not kernel else None
        for i in range(self.depth):
            attn = getattr(self, f"attn_{i}")
            inp = latents
            if pl is not None:
                inp = torch.cat([latents, pl], dim=-1) if self.plucker_input_strategy == "concat" else latents + pl
            if kernel:
                latents = attn(inp, x, lines=lines, geom=geom, tile_any=tile_any) + latents
            else:
                latents = attn(inp, x, dense_mask) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        if self.timestep_embedding_type != "none":
            frames = torch.arange(video_length, device=latents.device)
            t_emb = timestep_embedding(frames, self.timestep_embedding_dim).to(latents.dtype)
            if self.timestep_embedding_type == "sinusoidal_embedded":
                t_emb = self.temb_fc2(F.silu(self.temb_fc1(t_emb)))
            per_frame = latents.shape[1] // video_length
            latents = latents + t_emb.repeat_interleave(per_frame, dim=0)[None]
        if self.upscales:
            side = int(self.num_queries ** 0.5)
            h = latents.reshape(b * video_length, side, side, -1)
            for u in range(self.upscales):
                h = getattr(self, f"upscale_{u}")(h)
            latents = h.reshape(b, -1, h.shape[-1])
        return self.norm_out(self.proj_out(latents))


class MultiLatentAdaptor(nn.Module):
    """The PerceiverAttention variant, unmasked (reference adaptors.py:
    185-238): (B, L_ctx, embedding_dim) -> (B, video_length*num_queries,
    output_dim)."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64, heads: int = 16, num_queries: int = 8,
                 embedding_dim: int = 768, output_dim: int = 1024, ff_mult: int = 4,
                 video_length: Optional[int] = None, *, dtype=torch.float32):
        super().__init__()
        self.depth, self.dtype = depth, dtype
        self.latents = nn.Parameter(torch.empty(1, num_queries * (video_length or 1), dim))
        self.proj_in = Dense(embedding_dim, dim, dtype=dtype)
        for i in range(depth):
            setattr(self, f"attn_{i}", PerceiverAttention(dim, dim_head, heads, dtype=dtype))
            setattr(self, f"ff_{i}", ResamplerFeedForward(dim, ff_mult, dtype=dtype))
        self.proj_out = Dense(dim, output_dim, dtype=dtype)
        self.norm_out = LayerNormF32(output_dim)

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1).to(self.dtype)
        x = self.proj_in(x)
        for i in range(self.depth):
            latents = getattr(self, f"attn_{i}")(x, latents) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        return self.norm_out(self.proj_out(latents))
