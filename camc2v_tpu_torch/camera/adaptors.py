"""Context-frame latent adaptor of CamContextI2V's latent branch
(`camc2v_tpu/camera/adaptors.py`; reference model/modules/adaptors.py:36-182
and model/modules/utils.py:5-43).

`MultiLatentEpipolarAdaptor`: video_length * num_queries learned queries
cross-attend over the [cond ‖ context] VAE latents through `depth` layers of
epipolar-masked attention + feed-forward, get a per-frame timestep
embedding, and project to the latent width. Its mask is either computed in
K6 from the query lines (`lines`/`geom`/`tile_any`, the generation path at
256x256) or given as a dense (B, Lq, Lk) bool mask, which the attention seam
sends to K2 on the card. Output upscaling (`output_queries`,
TransposedConvolution) and the Plücker input are off in the flagship and
raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from camc2v_tpu_torch.core.schedules import timestep_embedding
from camc2v_tpu_torch.nn.epipolar import EpipolarCrossAttention
from camc2v_tpu_torch.nn.layers import Dense, LayerNormF32
from camc2v_tpu_torch.nn.resampler import ResamplerFeedForward


def cross_normalization(x: torch.Tensor, x_ref: torch.Tensor, axes: tuple[int, ...], eps: float = 1e-5):
    """x re-normalised to x_ref's mean and (unbiased) std over `axes`."""
    mean_ref = x_ref.mean(dim=axes, keepdim=True)
    std_ref = x_ref.std(dim=axes, keepdim=True, correction=1)
    mean_x = x.mean(dim=axes, keepdim=True)
    std_x = x.std(dim=axes, keepdim=True, correction=1)
    return (x - mean_x) * (std_ref / (std_x + eps)) + mean_ref


class MultiLatentEpipolarAdaptor(nn.Module):
    """(B, L_ctx, embedding_dim) context latents -> (B, T*num_queries, output_dim)."""

    def __init__(self, query_dim: int = 512, depth: int = 8, dim_head: int = 64, heads: int = 8,
                 num_queries: int = 1024, output_queries: Optional[int] = None, embedding_dim: int = 768,
                 output_dim: int = 1024, ff_mult: int = 4, num_register_tokens: int = 2, use_mask: bool = True,
                 video_length: Optional[int] = None, use_plucker_embedding: bool = False,
                 context_positional_encoding: bool = False, timestep_embedding_type: str = "none",
                 timestep_embedding_dim: int = 32, *, dtype=torch.float32):
        super().__init__()
        if (output_queries or num_queries) != num_queries or use_plucker_embedding or context_positional_encoding:
            raise NotImplementedError("MultiLatentEpipolarAdaptor: output upscaling, the Plücker input and the "
                                      "context positional encoding are not ported (off in the flagship)")
        if timestep_embedding_type not in ("none", "sinusoidal", "sinusoidal_embedded"):
            raise ValueError(f"unknown timestep_embedding_type '{timestep_embedding_type}'")
        self.depth, self.use_mask, self.dtype = depth, use_mask, dtype
        self.video_length = video_length
        self.timestep_embedding_type = timestep_embedding_type
        self.timestep_embedding_dim = timestep_embedding_dim
        total = num_queries * (video_length if video_length is not None else 1)
        self.latents = nn.Parameter(torch.empty(1, total, query_dim))
        self.proj_in = Dense(embedding_dim, query_dim, dtype=dtype)
        for i in range(depth):
            setattr(self, f"attn_{i}", EpipolarCrossAttention(
                query_dim, query_dim, query_dim, heads=heads, dim_head=dim_head,
                num_register_tokens=num_register_tokens, dtype=dtype))
            setattr(self, f"ff_{i}", ResamplerFeedForward(query_dim, ff_mult, dtype=dtype))
        if timestep_embedding_type == "sinusoidal_embedded":
            self.temb_fc1 = Dense(timestep_embedding_dim, query_dim, dtype=dtype)
            self.temb_fc2 = Dense(query_dim, query_dim, dtype=dtype)
        self.proj_out = Dense(query_dim, output_dim, dtype=dtype)
        self.norm_out = LayerNormF32(output_dim)

    def forward(self, x, mask: Optional[torch.Tensor] = None, *, use_mask: Optional[bool] = None,
                lines: Optional[torch.Tensor] = None, geom: Optional[tuple] = None,
                tile_any: Optional[torch.Tensor] = None):
        """mask: (B, T*num_queries, L_ctx) bool, used when masking is on and
        no `lines` are given; lines (B, T*num_queries, 1 + n_ctx, 3) with
        geom (1 + n_ctx, h, w, ds, block_k) select the in-kernel mask."""
        video_length = self.video_length if self.video_length is not None else 16
        b = x.shape[0]
        latents = self.latents.expand(b, -1, -1).to(self.dtype)
        x = self.proj_in(x)
        masking = self.use_mask if use_mask is None else use_mask
        kernel = masking and lines is not None
        dense_mask = mask if masking and not kernel else None
        for i in range(self.depth):
            attn = getattr(self, f"attn_{i}")
            if kernel:
                latents = attn(latents, x, lines=lines, geom=geom, tile_any=tile_any) + latents
            else:
                latents = attn(latents, x, dense_mask) + latents
            latents = getattr(self, f"ff_{i}")(latents) + latents
        if self.timestep_embedding_type != "none":
            frames = torch.arange(video_length, device=latents.device)
            t_emb = timestep_embedding(frames, self.timestep_embedding_dim).to(latents.dtype)
            if self.timestep_embedding_type == "sinusoidal_embedded":
                t_emb = self.temb_fc2(F.silu(self.temb_fc1(t_emb)))
            per_frame = latents.shape[1] // video_length
            latents = latents + t_emb.repeat_interleave(per_frame, dim=0)[None]
        return self.norm_out(self.proj_out(latents))
