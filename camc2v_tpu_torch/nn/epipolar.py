"""Epipolar-masked spatio-temporal attention (`camc2v_tpu/nn/epipolar.py`).

Two mask routes, the JAX package's:

  * The plain band (`plain_epipolar`: no variant is set) comes from the
    fundamental matrices of the camera payload, with the lines (and the
    kernels' tile maps) computed once per request by
    `prepare_plain_epipolar`. A level whose layout tiles the kernel
    (`kernel_tiling_ok`: the pixel ds8 and ds16 levels at 256x256) runs K6
    with the mask recomputed in the kernel, the register tokens at the end of
    the key axis. The other levels (the ds32 level and the middle block) and
    the adaptor's dense path (`camera/adaptors.py`) materialise the band.
  * Every other config (the hybrid fallbacks, the same-frame variants,
    `only_on_cond_frame`) gets its (B, T*hw, T*hw) masks from the payload's
    `masks` (`camera/geometry.py::build_epipolar_masks`); with
    `only_on_cond_frame` the keys are the conditioning frame's hw tokens and
    the mask is that frame's slice; `is_3d_full_attn` attends to every key
    with no mask. `prepare_masked_epipolar` builds each level's attention
    mask (the register columns in front, the conditioning-frame slice) and
    K2's padded form and tile map once per request (`mask_tiles`), since they
    depend on geometry only; without it the Epipolar module builds them at
    each call.

Every materialised mask goes through the `dot_product_attention` seam with
the register tokens in front, so on the card it reaches K2 (and K5 in
training) as a (B, Lq, Lk) bool mask shared by the heads; unmasked 3-D
attention reaches K2 without a mask. Both routes give the same attention; a
model built in f32 runs the plain twins (`ops.route`). Soft masks raise, as
in JAX (`camera/geometry.py::apply_mask_variants`).

With `CAMC2V_EPI_PRECOMP` set (anything but "0", as the JAX package reads
it), `sample` adds each in-kernel level's mask as bf16 additive penalties
(`add_precomputed_penalties`), and those levels take K6p instead of K6.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.config import EpipolarConfig
from camc2v_tpu_torch.nn.layers import Dense
from camc2v_tpu_torch.ops import epipolar_flash as ef
from camc2v_tpu_torch.ops import flash_attention as fa
from camc2v_tpu_torch.ops.attention import dot_product_attention


def plain_epipolar(cfg: EpipolarConfig) -> bool:
    """True when the mask is the pure `dist < thresh` band (no fallbacks)."""
    return not (
        cfg.is_3d_full_attn
        or cfg.apply_epipolar_soft_mask
        or cfg.epipolar_hybrid_attention
        or cfg.epipolar_hybrid_attention_v2
        or cfg.only_self_pixel_on_current_frame
        or cfg.current_frame_as_register_token
        or cfg.only_on_cond_frame
    )


def prepare_plain_epipolar(F: torch.Tensor, cfg: EpipolarConfig) -> dict[int, dict]:
    """{pixel_ds: {"lines", "tile_any"?}} for every level of the config, from
    the (B, T, T, 3, 3) fundamental matrices: geometry only, so a request
    computes it once for all its denoise steps. pixel_ds = 8 * ar for ar in
    `attention_resolution` (the Epipolar module's `origin_h // h` key). The
    in-kernel levels (the JAX rule) get the kernels' tile map, at their own
    128 x 64 tiling."""
    if not plain_epipolar(cfg):
        raise ValueError("prepare_plain_epipolar: the config is not the plain band (its masks come from "
                         "build_epipolar_masks)")
    t = F.shape[1]
    prep: dict[int, dict] = {}
    for ar in cfg.attention_resolution:
        ds = 8 * ar
        h, w = cfg.origin_h // ds, cfg.origin_w // ds
        if h < 1 or w < 1:
            continue
        lines = ef.epipolar_lines(F, h, w, ds)
        entry = {"lines": lines}
        hw = h * w
        block_k = ef.choose_block_k(hw)
        if ef.kernel_tiling_ok(t, hw, block_k):
            entry["tile_any"] = ef.kernel_tile_map(lines, t, h, w, ds)
        prep[ds] = entry
    return prep


def prepare_masked_epipolar(masks: dict[int, torch.Tensor], cfg: EpipolarConfig,
                            cond_frame_index: Optional[torch.Tensor] = None) -> dict[int, dict]:
    """{pixel_ds: {"mask_tiles": (padded, tile_any)}} from a non-plain
    config's (B, T*hw, T*hw) level masks: each level's attention mask as the
    Epipolar module forms it (the conditioning frame's key slice with
    `only_on_cond_frame`, then num_register_tokens True columns in front),
    in K2's padded form with its map of non-empty tiles
    (`ops/flash_attention.py::mask_tiles`). Geometry only, so a request
    builds it once for all its UNet calls."""
    prep = {}
    for ds, mask in masks.items():
        mask = _cond_frame_slice(mask, cfg, cond_frame_index, ds)
        prep[ds] = {"mask_tiles": fa.mask_tiles(_with_registers(mask, cfg.num_register_tokens))}
    return prep


def _cond_frame_slice(mask, cfg: EpipolarConfig, cond_frame_index, ds: int):
    """The (B, T*hw, hw) key slice of the conditioning frame with
    `only_on_cond_frame`, else the mask as it is."""
    if not cfg.only_on_cond_frame:
        return mask
    if cond_frame_index is None:
        raise ValueError("Epipolar: only_on_cond_frame needs the payload's cond_frame_index")
    b, lq, _ = mask.shape
    hw = (cfg.origin_h // ds) * (cfg.origin_w // ds)
    m = mask.reshape(b, lq, -1, hw)
    return m[torch.arange(b, device=mask.device), :, cond_frame_index.long().to(mask.device)]


def _with_registers(mask: torch.Tensor, nreg: int) -> torch.Tensor:
    """num_register_tokens always-visible key columns in front of a (B, Lq, Lk) mask."""
    if nreg == 0:
        return mask
    ones = torch.ones(mask.shape[0], mask.shape[1], nreg, dtype=torch.bool, device=mask.device)
    return torch.cat([ones, mask], dim=-1)


def add_precomputed_penalties(prep: dict[int, dict], cfg: EpipolarConfig, t: int,
                              max_level_bytes: Optional[int] = None) -> dict[int, dict]:
    """The request's epipolar prep with each in-kernel level's mask as bf16
    additive penalties (`ops/epipolar_flash.py::materialize_penalties`), for
    K6p (the JAX `add_precomputed_penalties`, `camc2v_tpu/nn/epipolar.py:
    77-118`): off unless `CAMC2V_EPI_PRECOMP` is set to anything but "0"; a
    level gets them when the JAX array, b*Lq*(Lq + block_k) bf16 values,
    stays within `max_level_bytes` (default 1.25e9). The port's array leaves
    out the JAX array's trailing block_k register/padding columns; the cap
    keeps the JAX formula, so the same levels get penalties. Sampling only:
    one camera geometry serves every denoise step."""
    if os.environ.get("CAMC2V_EPI_PRECOMP", "0") == "0":
        return prep
    if max_level_bytes is None:
        max_level_bytes = int(1.25e9)
    out = {}
    for ds, entry in prep.items():
        entry = dict(entry)
        lines = entry.get("lines")
        if lines is not None and "tile_any" in entry and "penalties" not in entry:
            h, w = cfg.origin_h // ds, cfg.origin_w // ds
            b, lq = lines.shape[:2]
            if b * lq * (lq + ef.choose_block_k(h * w)) * 2 <= max_level_bytes:
                entry["penalties"] = ef.materialize_penalties(lines, t, h, w, ds)
        out[ds] = entry
    return out


class EpipolarCrossAttention(nn.Module):
    """Masked cross-attention with learned register tokens (reference
    model/modules/epipolar.py:43-102).

    forward(x (B, L1, C), context (B, L2, Cc), attn_mask (B, L1, L2) bool or
    None, *, lines, geom, tile_any, penalties, mask_tiles): with `lines`
    (B, L1, t, 3) and `geom` (t, h, w, ds, block_k) the mask is computed in
    the kernel, or read from `penalties` (pb, L1, t*h*w) when given, and the
    registers ride at the end of the key axis (block_k names the tile map's
    layout). Otherwise the registers go in front of the keys with always-True
    mask columns; `mask_tiles` (from `prepare_masked_epipolar`) carries a
    mask that already has them, in K2's padded form, and `attn_mask` is then
    its unpadded view."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, out_dim: Optional[int] = None, *,
                 heads: int = 8, dim_head: int = 64, num_register_tokens: int = 0, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = query_dim if context_dim is None else context_dim
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        self.num_register_tokens = num_register_tokens
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(ctx_dim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim if out_dim is None else out_dim, dtype=dtype)
        if num_register_tokens > 0:
            self.register_tokens = nn.Parameter(torch.empty(1, num_register_tokens, ctx_dim))

    def _registers(self, b: int, like: torch.Tensor) -> torch.Tensor:
        return self.register_tokens.expand(b, -1, -1).to(like.dtype)

    def forward(self, x, context, attn_mask=None, *, lines=None, geom=None, tile_any=None, penalties=None,
                mask_tiles=None):
        b = x.shape[0]
        split = lambda z: z.reshape(z.shape[0], z.shape[1], self.heads, self.dim_head)
        q = self.to_q(x)
        nreg = self.num_register_tokens
        if lines is not None:
            if attn_mask is not None or geom is None:
                raise ValueError("EpipolarCrossAttention: the lines path takes geom and no attn_mask")
            t, hh, ww, ds, block_k = geom
            if nreg > 0:
                context = torch.cat([context, self._registers(b, context)], dim=1)
            k, v = self.to_k(context), self.to_v(context)
            kw = dict(t=t, h=hh, w=ww, downsample=ds, num_registers=nreg)
            out = ef.epipolar_flash_attention(split(q).contiguous(), split(k).contiguous(), split(v).contiguous(),
                                              lines, block_k=block_k, tile_any=tile_any, penalties=penalties,
                                              kernel=ops.route(q), **kw)
        else:
            if nreg > 0:
                context = torch.cat([self._registers(b, context), context], dim=1)
                if attn_mask is not None and mask_tiles is None:
                    attn_mask = _with_registers(attn_mask, nreg)
            k, v = self.to_k(context), self.to_v(context)
            out = dot_product_attention(split(q), split(k), split(v),
                                        mask=None if attn_mask is None else attn_mask[:, None],
                                        mask_tiles=mask_tiles)
        return self.to_out(out.reshape(b, -1, self.heads * self.dim_head))


class Epipolar(nn.Module):
    """Attention over the T*h*w tokens of a level, masked by epipolar geometry
    (reference model/modules/epipolar.py:105-157): features (B, T, h, w, C)
    -> (B*h*w, T, C), the temporal stream's token layout."""

    def __init__(self, config: EpipolarConfig, query_dim: int, heads: int, *, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dim_head = int(query_dim // heads // config.compression_factor)
        self.epipolar_attn = EpipolarCrossAttention(
            query_dim, query_dim, heads=heads, dim_head=self.dim_head,
            num_register_tokens=config.num_register_tokens, dtype=dtype,
        )

    def forward(self, features, F=None, prep: Optional[dict] = None, masks: Optional[dict] = None,
                cond_frame_index: Optional[torch.Tensor] = None):
        """The camera payload's parts: F (B, T, T, 3, 3) fundamental matrices
        and prep (`prepare_plain_epipolar`, lines recomputed from F without
        it) for the plain band; masks {pixel_ds: (B, T*hw, T*hw)} and prep
        (`prepare_masked_epipolar`, else built here) for the other configs;
        cond_frame_index (B,) for `only_on_cond_frame`."""
        b, t, hh, ww, c = features.shape
        cfg = self.config
        ds = cfg.origin_h // hh
        hw = hh * ww
        x = features.reshape(b, t * hw, c)
        level = (prep or {}).get(ds, {})
        context = x
        if cfg.only_on_cond_frame:
            if cond_frame_index is None:
                raise ValueError("Epipolar: only_on_cond_frame needs the payload's cond_frame_index")
            context = features[torch.arange(b, device=x.device), cond_frame_index.long().to(x.device)]
            context = context.reshape(b, hw, c)
        if cfg.is_3d_full_attn:
            out = self.epipolar_attn(x, context)
        elif plain_epipolar(cfg):
            out = self._plain(x, F, level, t, hh, ww, ds)
        elif "mask_tiles" in level:
            padded, _ = tiles = level["mask_tiles"]
            lk = cfg.num_register_tokens + context.shape[1]
            out = self.epipolar_attn(x, context, padded[:, : t * hw, :lk], mask_tiles=tiles)
        else:
            mask = (masks or {}).get(ds)
            if mask is None:
                raise ValueError(f"Epipolar: the camera payload has no mask for pixel ds {ds}")
            out = self.epipolar_attn(x, context, _cond_frame_slice(mask, cfg, cond_frame_index, ds))
        return out.reshape(b, t, hw, -1).transpose(1, 2).reshape(b * hw, t, -1)

    def _plain(self, x, F, level: dict, t: int, hh: int, ww: int, ds: int):
        lines = level.get("lines")
        if lines is None:
            if F is None:
                raise ValueError("Epipolar: the camera payload has neither F nor prepared lines for this level")
            lines = ef.epipolar_lines(F, hh, ww, ds)
        hw = hh * ww
        block_k = ef.choose_block_k(hw)
        # the JAX dispatch; on the card K6 also needs its head dim (64 at every flagship level)
        kernel_ok = ef.kernel_tiling_ok(t, hw, block_k) and (not x.is_cuda or ef.head_dim_ok(self.dim_head))
        if kernel_ok:
            return self.epipolar_attn(x, x, lines=lines, geom=(t, hh, ww, ds, block_k),
                                      tile_any=level.get("tile_any"), penalties=level.get("penalties"))
        return self.epipolar_attn(x, x, ef.materialize_mask(lines, t, hh, ww, ds))
