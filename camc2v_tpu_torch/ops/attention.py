"""Functional attention seam (`camc2v_tpu/ops/attention.py`).

`dot_product_attention(q, k, v, ...)` over (B, L, H, D) is the one entry
point every attention module calls. Every call without a bias and with a
mask shared by the heads goes through `flash_attention`'s autograd Function:
on the card the flash kernels K2 (forward, with its logsumexp when a gradient
is wanted) and K5 (backward), elsewhere and at the sites below their plain
twins (`flash_fwd_plain`, `flash_bwd_plain`). The other calls run
`xla_attention`, the plain path with the JAX numerics (bf16 products
accumulated in f32, f32 softmax, probabilities cast to the input dtype for
the PV product).

Sites that stay plain on the card, and why:
  * calls with an additive `bias` (the temporal relative-position bias of
    `use_relative_position`, off in every shipped config; `xla_attention`):
    K2 takes masks, not biases, as the Pallas kernel does;
  * per-head masks (a mask whose head axis is > 1; `xla_attention`): K2
    shares one mask across heads; no model site builds one;
  * head dims that are not a multiple of 16 or exceed 128: the VAE
    mid-block's single-head D=512 attention (`nn/vae.py::AEAttnBlock`, one
    call per encode or decode) and the pose encoder's temporal attention at
    its first and last two levels (`camera/pose_encoder.py`, 8 heads of
    D = 40 at C = 320 and D = 160 at C = 1280, over 16 frames; once per
    request): K2's K/V tiles take 16-wide slices and its f32 output
    accumulator is sized for D <= 128;
  * f32 inputs (a model built in f32): K2 is a bf16 kernel (`ops.route`).

Model sites that do reach K2: the UNet's spatial self-attention over more
than 32 tokens and its text/image cross-attention (D = 64), the CLIP text
tower (D = 64, one causal (1, 1, 77, 77) mask shared by the batch), the
CLIP vision tower (D = 80, Lq = Lk = 257, no mask), the pose encoder's
D = 80 level (C = 640), and the epipolar attention where its mask is
materialised (`nn/epipolar.py`: with the plain band the ds32 level and the
middle block; with any other variant every level, up to (B, 16384, 4 +
16384) at ds8, or (B, 16384, 4 + 1024) with `only_on_cond_frame`; D = 64, a
mask shared by the heads; with `is_3d_full_attn` no mask), and the temporal
transformer's causal mask (`use_causal_attention`, one (1, 1, T, T) mask
shared by every row). The Resampler's attention does
not use this seam (`nn/resampler.py`).
"""

from __future__ import annotations

from typing import Optional

import torch

from camc2v_tpu_torch import ops


def xla_attention(q, k, v, *, bias=None, mask=None, scale: float):
    """Plain twin of `_xla_attention`: q/k/v (B, L, H, D); mask broadcastable
    to (B, H, Lq, Lk), True = attend."""
    dtype = q.dtype
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(dtype).float(), v.float())
    return out.to(dtype)


def _head_shared_mask(mask: torch.Tensor, b: int, lq: int, lk: int) -> Optional[torch.Tensor]:
    """(B|1, 1|absent, Lq|1, Lk) bool mask -> (B|1, Lq, Lk), or None when the
    mask differs per head."""
    if mask.dim() == 4:
        if mask.shape[1] != 1:
            return None
        mask = mask[:, 0]
    return mask.expand(mask.shape[0], lq, lk)


def dot_product_attention(q, k, v, *, bias=None, mask=None, scale: Optional[float] = None, mask_tiles=None):
    """Multi-head scaled dot-product attention over (B, L, H, D) -> (B, Lq, H, D).

    Every call without a bias and with a head-shared mask goes through
    `flash_attention` (K2 and K5 where the route and head dim allow, their
    plain twins elsewhere); the rest runs `xla_attention`. mask_tiles: the
    head-shared mask's `flash_attention.mask_tiles`, when the caller holds
    them (built per call otherwise)."""
    from camc2v_tpu_torch.ops import flash_attention as fa

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is None:
        b, lq, _, _ = q.shape
        fmask = None if mask is None else _head_shared_mask(mask, b, lq, k.shape[1])
        if mask is None or fmask is not None:
            return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask=fmask, scale=scale,
                                      kernel=ops.route(q) and fa.flash_supported(q), tiles=mask_tiles)
    return xla_attention(q, k, v, bias=bias, mask=mask, scale=scale)


def attention_merged_heads(q, k, v, num_heads: int, **kwargs):
    """Attention over (B, L, H*D) inputs, splitting/merging heads internally."""
    b, lq, inner = q.shape
    d = inner // num_heads
    split = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d)
    return dot_product_attention(split(q), split(k), split(v), **kwargs).reshape(b, lq, inner)
