"""Flash attention over (B, L, H, D): kernels K2 (forward) and K5 (backward).

K2 (`csrc/flash_attention.cu`) replaces the Pallas kernels
`camc2v_tpu/ops/flash_attention.py::_fwd_kernel_nomask` / `_fwd_kernel` /
`_fwd_kernel_sparse` (entry `flash_attention`): online softmax over key
tiles, q pre-scaled in bf16, an optional (B, Lq, Lk) bool mask shared by the
heads, empty mask tiles skipped, keys past Lk masked, fully masked rows 0.
When the caller needs a gradient it also writes each row's logsumexp, the
TPU kernel's `with_stats` output (`_finalize`): m + log l, +1e30 for a fully
masked row.

K5 (`csrc/flash_bwd.cu`) replaces `_bwd_dq_kernel` / `_bwd_dkv_kernel`
(`_flash_bwd_impl`, the custom VJP of `flash_attention`): from q, k, v, the
mask, out, lse and dout it computes dq, dk, dv with delta = rowsum(dout·out)
in f32, p = exp(s - lse), ds = p·(dp - delta), empty tiles skipped and zero
gradient for a fully masked row. Its pre-pass kernel forms qs = bf16(q·scale)
and delta on the card; `bwd_prepass_plain` is its plain version.

Both kernels are built for Hopper on one core, `csrc/flash_hopper.cuh`
(TMA copies into an mbarrier ring, wgmma products with register
accumulators): it tiles queries by 128 and keys by 64, and the wrapper gives
it the mask zero-padded to whole tiles with the map of its non-empty tiles
on that grid (`mask_tiles`; per call, or once per request where the caller
holds them, as the epipolar variants' masks do).

`flash_attention` runs `_Flash`, whose forward is K2 (with the lse when a
gradient is wanted) and whose backward is K5, or the plain twins
`flash_fwd_plain` / `flash_bwd_plain`. The mask gets no gradient.

Bound on the H100: tensor cores at the long spatial self-attention
(Lq = Lk = 1024 at the UNet's top level), launch and latency at the short
cross-attention keys.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build

# the kernels' query and key tiles (BQ, BK in csrc/flash_hopper.cuh): the
# padded mask and its non-empty-tile map are built on this grid
BLOCK_Q = 128
BLOCK_K = 64
NEG_INF = -1e30
M_FLOOR = -1e20
LSE_MASKED = 1e30
TWIN_CHUNK = 512  # queries per chunk of the backward twin


def flash_supported(q: torch.Tensor) -> bool:
    """Static eligibility: bf16 with a head dim the kernel's tiles take."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 128


def flash_attention(q, k, v, *, mask: Optional[torch.Tensor] = None, scale: Optional[float] = None,
                    kernel: bool = True, tiles: Optional[tuple[torch.Tensor, torch.Tensor]] = None):
    """Attention over (B, L, H, D) through `_Flash`. mask: (B or 1, Lq, Lk)
    bool, True = attend; tiles: its `mask_tiles`, when the caller holds
    them. CPU tensors take the plain twins; CUDA tensors launch K2 + K5
    (which raise on shapes they cannot take) unless `kernel` is False (the
    seam's plain route)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, mask, scale, ops.on_card(q, "flash_attention") and kernel, tiles)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, scale, kernel, tiles):
        want_lse = any(ctx.needs_input_grad[:3])
        twin = functools.partial(flash_fwd_plain, scale=scale)
        run = functools.partial(_launch_fwd, scale=scale, want_lse=want_lse, tiles=tiles) if kernel else twin
        # a gradient's forward is a dispatcher op, so a remat policy can save it
        out, lse = ops.saved_forward(run, twin, q, k, v, mask) if want_lse else run(q, k, v, mask)
        ctx.scale, ctx.kernel, ctx.tiles = scale, kernel, tiles
        if want_lse:
            ctx.save_for_backward(q, k, v, mask, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if ctx.kernel:
            dq, dk, dv = flash_bwd(q, k, v, mask, out, lse, dout.contiguous(), ctx.scale, tiles=ctx.tiles)
        else:
            dq, dk, dv = flash_bwd_plain(q, k, v, mask, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None, None, None, None


def _masked_logits(qs, k, mask):
    """(B, H, Lq, Lk) f32 logits of the pre-scaled queries, -1e30 where the
    (B|1, Lq, Lk) mask hides a key."""
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    return s if mask is None else torch.where(mask[:, None], s, NEG_INF)


def flash_fwd_plain(q, k, v, mask, scale):
    """Plain twin of K2 with its lse, (out (B, Lq, H, D), lse (B, H, Lq) f32):
    the JAX kernel's arithmetic (q pre-scaled in its own dtype, f32 logits,
    max floored at -1e20, probabilities cast to v's dtype for the PV
    product, fully masked rows 0 with lse +1e30)."""
    qs = q * torch.tensor(scale, dtype=q.dtype)
    s = _masked_logits(qs, k, mask)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l == 0, torch.full_like(l, LSE_MASKED), m + torch.log(l))[..., 0]
    return out, lse


def attention_bwd_chunk(qs, k, v, dout, lse, delta, mask):
    """One query chunk of the flash backward (the JAX `_bwd_dq_kernel` /
    `_bwd_dkv_kernel` arithmetic): qs (B, c, H, D) pre-scaled; lse, delta
    (B, H, c) f32; mask (B|1, c, Lk) bool or None. Returns dqs (B, c, H, D)
    f32 (dL/dqs) and this chunk's f32 contributions to dk and dv (B, Lk, H, D)."""
    s = _masked_logits(qs, k, mask)
    p = torch.exp(s - lse[..., None])  # masked logits and fully masked rows give 0
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta[..., None])
    dsb = ds.to(k.dtype).float()
    dqs = torch.einsum("bhqk,bkhd->bqhd", dsb, k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    return dqs, dk, dv


def _delta(out, dout):
    """rowsum(dout · out) in f32, (B, H, Lq)."""
    return (dout.float() * out.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def bwd_prepass_plain(q, out, dout, scale):
    """Plain version of K5's pre-pass, the JAX backward's own formulas:
    (qs = q·bf16(scale) in q's dtype (B, Lq, H, D), delta (B, H, Lq) f32)."""
    return q * torch.tensor(scale, dtype=q.dtype), _delta(out, dout)


def attention_bwd_plain(q, k, v, out, lse, dout, scale, chunk_mask):
    """The chunked backward twin of K5 and K7: (dq, dk, dv) in the input
    dtypes, `chunk_mask(s, e)` giving the (B|1, e - s, Lk) bool mask of
    queries [s, e) or None; dk and dv summed in f32 over the chunks, dq
    formed as the JAX backward does (`cast(dqs) * scale` in q's dtype)."""
    lq = q.shape[1]
    qs, delta = bwd_prepass_plain(q, out, dout, scale)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for s in range(0, lq, TWIN_CHUNK):
        e = min(lq, s + TWIN_CHUNK)
        dqs, dkc, dvc = attention_bwd_chunk(qs[:, s:e], k, v, dout[:, s:e], lse[..., s:e], delta[..., s:e],
                                            chunk_mask(s, e))
        dq[:, s:e] = dqs.to(q.dtype) * torch.tensor(scale, dtype=q.dtype)
        dk += dkc
        dv += dvc
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, mask, out, lse, dout, scale):
    """Plain twin of K5: (dq, dk, dv), chunked over queries."""
    return attention_bwd_plain(q, k, v, out, lse, dout, scale,
                               lambda s, e: None if mask is None else mask[:, s:e])


def mask_tiles(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' view of a (B|1, Lq, Lk) bool mask: the mask zero-padded
    to whole tiles, (B|1, ceil(Lq/128)·128, ceil(Lk/64)·64) bool, and the
    (B|1, ceil(Lq/128), ceil(Lk/64)) uint8 map of its non-empty tiles. A
    caller whose mask serves many calls (the epipolar variants' masks, one
    geometry per request) builds this once and passes it as `tiles`; the
    unpadded mask is then the view `padded[:, :Lq, :Lk]`."""
    mb, lq, lk = mask.shape
    nq, nk = -(-lq // BLOCK_Q), -(-lk // BLOCK_K)
    padded = torch.zeros(mb, nq * BLOCK_Q, nk * BLOCK_K, dtype=torch.bool, device=mask.device)
    padded[:, :lq, :lk] = mask
    tile_any = padded.view(mb, nq, BLOCK_Q, nk, BLOCK_K).any(dim=4).any(dim=2)
    return padded, tile_any.to(torch.uint8)


def _tiles(mask, b, lq, lk, tiles=None):
    """The kernels' view of a (B|1, Lq, Lk) mask: its padded form and the
    (B, ceil(Lq/128), ceil(Lk/64)) uint8 map of non-empty tiles, contiguous,
    from `tiles` (its `mask_tiles`) or built here."""
    padded, tile_any = mask_tiles(mask) if tiles is None else tiles
    nq, nk = -(-lq // BLOCK_Q), -(-lk // BLOCK_K)
    if padded.shape != (mask.shape[0], nq * BLOCK_Q, nk * BLOCK_K) or tile_any.shape != (mask.shape[0], nq, nk):
        raise ValueError(f"flash attention: tiles {tuple(padded.shape)}/{tuple(tile_any.shape)} do not match the "
                         f"mask {tuple(mask.shape)} (`mask_tiles`)")
    return padded, tile_any.expand(b, nq, nk).contiguous()


def _check(q, k, v, mask, what, tiles=None):
    """The kernels' contract; returns (padded mask, tile map, mask batch
    stride), or (None, None, 0) without a mask. tiles: `mask_tiles(mask)`,
    built here when absent."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous bf16 on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary (the kernels copy it by TMA)")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"{what}: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if not flash_supported(q):
        raise ValueError(f"{what}: head dim {d} (needs a multiple of 16, <= 128)")
    if mask is None:
        return None, None, 0
    if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[1:] != (lq, lk) or mask.shape[0] not in (1, b):
        raise ValueError(f"{what}: mask {tuple(mask.shape)} {mask.dtype} (needs bool (B|1, Lq, Lk))")
    padded, tile_any = _tiles(mask, b, lq, lk, tiles)
    return padded, tile_any, 0 if mask.shape[0] == 1 else padded[0].numel()


def _ptr(t):
    return 0 if t is None else t.data_ptr()


_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_FWD_ARGS = [_P] * 7 + [_I] * 5 + [_F, _LL, _P]
_BWD_ARGS = [_P] * 14 + [_I] * 5 + [_F, _LL, _P]


@functools.lru_cache(maxsize=32)
def _bf16(x: float) -> float:
    """x rounded to bf16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def _launch_fwd(q, k, v, mask, scale, *, want_lse: bool, tiles=None):
    """K2: (out, lse (B, H, Lq) f32 when `want_lse`, else None)."""
    mask, tile_any, mask_bstride = _check(q, k, v, mask, "flash_attention", tiles)
    b, lq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, lq, dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.function("flash_attention", "flash_fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask), _ptr(tile_any), out.data_ptr(), _ptr(lse),
             b, lq, k.shape[1], h, d, _bf16(scale), mask_bstride, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    ops.LAUNCHES["flash_attention"] += 1
    return out, lse


def flash_bwd(q, k, v, mask, out, lse, dout, scale, *, tiles=None):
    """K5: (dq, dk, dv) bf16 from K2's out and lse (B, H, Lq) and dout; the
    pre-pass (qs, delta) runs on the card inside the launch."""
    mask, tile_any, mask_bstride = _check(q, k, v, mask, "flash_bwd", tiles)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    for name, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_bwd: {name} {tuple(t.shape)} {t.dtype} vs q {tuple(q.shape)} (needs contiguous "
                             "bf16 on a 16-byte boundary)")
    if lse.shape != (b, h, lq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: lse {tuple(lse.shape)} {lse.dtype} (needs f32 (B, H, Lq))")
    lse = lse.contiguous()
    lqp = -(-lq // BLOCK_Q) * BLOCK_Q
    qs = torch.empty_like(q)
    lse_pad = torch.empty(b, h, lqp, dtype=torch.float32, device=q.device)
    delta_pad = torch.empty_like(lse_pad)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("flash_bwd", "flash_bwd", _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
             _ptr(mask), _ptr(tile_any), qs.data_ptr(), lse_pad.data_ptr(), delta_pad.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq, lk, h, d, _bf16(scale), mask_bstride,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd")
    ops.LAUNCHES["flash_bwd"] += 1
    return dq, dk, dv
