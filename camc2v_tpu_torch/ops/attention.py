"""Functional attention seam (`camc2v_tpu/ops/attention.py`).

`dot_product_attention(q, k, v, ...)` over (B, L, H, D) is the one entry
point every attention module calls. On the card every call without a bias
goes to the flash kernel K2 (`ops/flash_attention.py`); everywhere else it
runs `xla_attention`, the plain twin with the JAX plain-path numerics (bf16
products accumulated in f32, f32 softmax, probabilities cast to the input
dtype for the PV product).

Sites that stay plain on the card, and why:
  * calls with an additive `bias` (the temporal relative-position bias; off
    in every shipped config): K2 takes masks, not biases;
  * per-head masks (a mask whose head axis is > 1): K2 shares one mask
    across heads; no model site builds one;
  * head dims that are not a multiple of 16 or exceed 128, i.e. the VAE
    mid-block's single-head D=512 attention (`nn/vae.py::AEAttnBlock`, one
    call per encode or decode): K2's f32 output accumulator and K/V tiles
    are sized for D <= 128;
  * f32 inputs (a model built in f32): K2 is a bf16 kernel (`ops.route`).

Model sites that do reach K2: the UNet's spatial self-attention over more
than 32 tokens and its text/image cross-attention (D = 64), the CLIP text
tower (D = 64, one causal (1, 1, 77, 77) mask shared by the batch), and the
CLIP vision tower (D = 80, Lq = Lk = 257, no mask). The Resampler's
attention does not use this seam (`nn/resampler.py`).
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


def dot_product_attention(q, k, v, *, bias=None, mask=None, scale: Optional[float] = None):
    """Multi-head scaled dot-product attention over (B, L, H, D) -> (B, Lq, H, D)."""
    from camc2v_tpu_torch.ops import flash_attention as fa

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if bias is None and ops.route(q) and fa.flash_supported(q):
        b, lq, _, _ = q.shape
        fmask = None if mask is None else _head_shared_mask(mask, b, lq, k.shape[1])
        if mask is None or fmask is not None:
            return fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), mask=fmask, scale=scale)
    return xla_attention(q, k, v, bias=bias, mask=mask, scale=scale)


def attention_merged_heads(q, k, v, num_heads: int, **kwargs):
    """Attention over (B, L, H*D) inputs, splitting/merging heads internally."""
    b, lq, inner = q.shape
    d = inner // num_heads
    split = lambda t: t.reshape(t.shape[0], t.shape[1], num_heads, d)
    return dot_product_attention(split(q), split(k), split(v), **kwargs).reshape(b, lq, inner)
