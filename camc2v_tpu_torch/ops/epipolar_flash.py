"""Epipolar flash attention with the mask computed in the kernels: K6 (forward)
and K7 (backward).

The CUDA kernel (`csrc/epipolar_flash.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/epipolar_flash.py::_v2_kernel` (entry
`epipolar_flash_attention`, in-kernel mask path): online-softmax attention of
q (B, Lq, H, D) over k/v (B, t*h*w + num_registers, H, D) where the mask bit
of query i and frame key j is recomputed from i's normalised epipolar line
(a, b, c) in j's frame as |a*px + b*py + c| < ds*sqrt(2)/2, so no (B, Lq, Lk)
array exists. Register tokens sit at the END of the key axis and are always
visible (attention is invariant to the reordering from the reference's front
position). Key subtiles that the hull bitmap `tile_any` marks empty for a
256-query tile are skipped; NaN lines (F == 0) hide their whole key frame and
fully masked rows give 0. The tile map keeps the JAX layout, registers in a
trailing block_k tile whose first subtile is always set; the keys themselves
are not padded to it.

The geometry helpers (`epipolar_lines`, `epipolar_tile_map`,
`materialize_mask`, the tiling rules) are exact ports of the JAX functions:
the tile map and the lines feed the kernel, and the CPU tests hold them to
the JAX package bit for bit. Every mask distance is formed in one operation
order, `(a*px + b*py) + c` with each product and sum rounded to f32 (eager
torch elementwise ops here, `__fmul_rn`/`__fadd_rn` in the kernel), so the
kernel and its twin agree on every bit.

K7 (`csrc/epipolar_bwd.cu`) replaces the Pallas kernels `_v2_bwd_dq_kernel`
/ `_v2_bwd_dkv_kernel` (`_epipolar_flash_bwd_impl`, the custom VJP of
`epipolar_flash_attention`): dq, dk, dv from K6's logsumexp with the mask
bits recomputed from the lines by the same policy (`csrc/epipolar_mask.cuh`)
and the same subtile skips. `epipolar_flash_attention` runs `_Epipolar`:
K6 (with the lse when a gradient is wanted) and K7, or the plain twins;
lines and tile map get no gradient.

The least time the function needs counts 4*D operations per query-key pair
whose mask bit is set (`mask_pairs`; the backward 10*D); the work K6 does
after skipping counts every pair of the subtiles the map leaves on
(`visible_pairs`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build
from camc2v_tpu_torch.ops.flash_attention import LSE_MASKED, _delta, _ptr, attention_bwd_plain

# canonical tiling of the tile maps (the JAX package's, so maps agree bit for
# bit): 256-query rows, 1024-key tiles, skip granularity SUBTILE
BLOCK_Q = 256
BLOCK_K = 1024
SUBTILE = 256
NEG_INF = -1e30
M_FLOOR = -1e20
# the kernel's query and key tiles (BQ, BK in csrc/flash_core.cuh)
KERNEL_BQ = 64
KERNEL_BK = 64
TWIN_CHUNK = 512  # queries per chunk of the plain twin


def pix2coord(x, downsample: int):
    """Pixel index -> continuous image coordinate (reference epipolar.py:32-35)."""
    return x * downsample + downsample / 2.0 - 0.5


def _pixel_grid(h: int, w: int, downsample: int, device):
    """(hw,) f32 x and y image coordinates of the feature-map cell centres,
    raster order."""
    y = pix2coord(torch.arange(h, dtype=torch.float32, device=device), downsample)
    x = pix2coord(torch.arange(w, dtype=torch.float32, device=device), downsample)
    return x.repeat(h), y.repeat_interleave(w)


def epipolar_lines(F: torch.Tensor, h: int, w: int, downsample: int) -> torch.Tensor:
    """Normalised epipolar lines of every query pixel in every key frame.

    F: (B, T1, T2, 3, 3) fundamental matrices. Returns (B, T1*h*w, T2, 3) f32
    with ||l[:2]|| == 1, NaN where F == 0 (every distance test then fails).
    The three-term products are written out elementwise in f32, so no TF32
    or matmul blocking touches the lines."""
    F = F.float()
    b, t1, t2 = F.shape[:3]
    gx, gy = _pixel_grid(h, w, downsample, F.device)
    f = F[:, :, None]  # (B, T1, 1, T2, 3, 3)
    lines = f[..., 0] * gx[None, None, :, None, None] + f[..., 1] * gy[None, None, :, None, None] + f[..., 2]
    norm = torch.sqrt(lines[..., 0] * lines[..., 0] + lines[..., 1] * lines[..., 1])[..., None]
    return (lines / norm).reshape(b, t1 * h * w, t2, 3)


def choose_block_k(hw: int) -> int:
    """The canonical key tile of a level: BLOCK_K where it tiles the frame
    layout (divides hw or spans whole frames), else one frame per tile."""
    return BLOCK_K if (hw % BLOCK_K == 0 or BLOCK_K % hw == 0) else hw


def kernel_tiling_ok(t: int, hw: int, block_k: int) -> bool:
    """The level's layout takes the in-kernel mask (the JAX rule; head dims
    are the caller's concern)."""
    return min(block_k, hw) >= 256 and (t * hw) % block_k == 0 and (t * hw) % BLOCK_Q == 0


def head_dim_ok(d: int) -> bool:
    """K6 takes head dims that are a multiple of 16 up to 128."""
    return d % 16 == 0 and d <= 128


def epipolar_tile_map(lines: torch.Tensor, t: int, h: int, w: int, downsample: int,
                      block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> torch.Tensor:
    """(B, Lq/block_q, nK*nsub) int32 map of possibly visible SUBTILE key
    ranges per query tile; nK counts the trailing register tile, whose first
    subtile is always set.

    Exactly safe: a subtile is empty only when every query line's distance
    over the subtile's pixel-centre hull is >= thresh; the affine distance's
    hull minimum separates per axis."""
    b, lq, t2, _ = lines.shape
    hw = h * w
    sub = min(SUBTILE, block_k, hw)
    nsub = block_k // sub
    rows_per_sub = sub // w
    n_subs_frame = hw // sub
    thresh = downsample * math.sqrt(2.0) / 2.0
    a, bb, c = lines[..., 0], lines[..., 1], lines[..., 2]
    x0 = pix2coord(0.0, downsample)
    x1 = pix2coord(float(w - 1), downsample)
    idx = torch.arange(n_subs_frame, dtype=torch.float32, device=lines.device)
    y0s = pix2coord(idx * rows_per_sub, downsample)
    y1s = pix2coord((idx + 1) * rows_per_sub - 1, downsample)
    ax_min = torch.minimum(a * x0, a * x1)
    ax_max = torch.maximum(a * x0, a * x1)
    by0 = bb[..., None] * y0s
    by1 = bb[..., None] * y1s
    vmin = ax_min[..., None] + torch.minimum(by0, by1) + c[..., None]
    vmax = ax_max[..., None] + torch.maximum(by0, by1) + c[..., None]
    sign_change = (vmin < 0) & (vmax > 0)
    min_abs = torch.where(sign_change, torch.zeros_like(vmin), torch.where(vmin > 0, vmin, -vmax))
    hit = min_abs < thresh  # NaN lines -> False
    nq = lq // block_q
    hit = hit.reshape(b, nq, block_q, t2 * n_subs_frame).any(dim=2)
    reg = torch.zeros(b, nq, nsub, dtype=torch.bool, device=lines.device)
    reg[..., 0] = True
    return torch.cat([hit, reg], dim=-1).to(torch.int32)


def _distance_mask(lines: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, thresh: float) -> torch.Tensor:
    """(..., T, 3) lines x (hw,) coordinates -> (..., T*hw) bool, in the
    kernel's operation order."""
    a, bb, c = lines[..., 0:1], lines[..., 1:2], lines[..., 2:3]
    dist = torch.abs(a * gx + bb * gy + c)
    return (dist < thresh).flatten(-2)


def materialize_mask(lines: torch.Tensor, t: int, h: int, w: int, downsample: int) -> torch.Tensor:
    """(B, Lq, t*h*w) bool mask from lines: the in-kernel mask written out."""
    gx, gy = _pixel_grid(h, w, downsample, lines.device)
    return _distance_mask(lines.float(), gx, gy, downsample * math.sqrt(2.0) / 2.0)


def _chunk_mask(lines, gx, gy, thresh, num_registers):
    """(B, c, t*hw + num_registers) bool mask of a query chunk, registers last."""
    mask = _distance_mask(lines.float(), gx, gy, thresh)
    reg = torch.ones(*mask.shape[:2], num_registers, dtype=torch.bool, device=mask.device)
    return torch.cat([mask, reg], dim=-1)


def epipolar_attention_plain(q, k, v, lines, *, t: int, h: int, w: int, downsample: int,
                             num_registers: int, scale: Optional[float] = None, return_lse: bool = False):
    """Plain twin of K6 over the kernel's layout, chunked over queries.

    q (B, Lq, H, D); k/v (B, t*h*w + num_registers, H, D), the register keys
    last; lines (B, Lq, t, 3). The JAX plain-path numerics: q pre-scaled in
    its own dtype, products accumulated in f32, masked logits
    -1e30, running max floored at -1e20, probabilities cast to v's dtype for
    the PV product, fully masked rows 0. Chunking keeps the f32 logits at
    (B, H, chunk, Lk): dense logits at the ds8 site would be 11 GB.
    return_lse: also the rows' logsumexp (B, H, Lq) f32, +1e30 where a row
    is fully masked (K6's training output)."""
    b, lq, heads, d = q.shape
    if scale is None:
        scale = d ** -0.5
    gx, gy = _pixel_grid(h, w, downsample, q.device)
    thresh = downsample * math.sqrt(2.0) / 2.0
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, lq, dtype=torch.float32, device=q.device) if return_lse else None
    for s in range(0, lq, TWIN_CHUNK):
        e = min(lq, s + TWIN_CHUNK)
        mask = _chunk_mask(lines[:, s:e], gx, gy, thresh, num_registers)[:, None]
        logits = torch.einsum("bqhd,bkhd->bhqk", qs[:, s:e], kf)
        logits = torch.where(mask, logits, NEG_INF)
        m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=M_FLOOR)
        p = torch.exp(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf)
        acc = acc / torch.where(l == 0, torch.ones_like(l), l)
        out[:, s:e] = acc.permute(0, 2, 1, 3).to(q.dtype)
        if lse is not None:
            lse[..., s:e] = torch.where(l == 0, torch.full_like(l, LSE_MASKED), m + torch.log(l))[..., 0]
    return (out, lse) if return_lse else out


def epipolar_bwd_plain(q, k, v, lines, out, lse, dout, *, t: int, h: int, w: int, downsample: int,
                       num_registers: int, scale: float):
    """Plain twin of K7: (dq, dk, dv), chunked over queries, each chunk's mask
    rebuilt from its lines (the twin's bits)."""
    gx, gy = _pixel_grid(h, w, downsample, q.device)
    thresh = downsample * math.sqrt(2.0) / 2.0
    return attention_bwd_plain(q, k, v, out, lse, dout, scale,
                               lambda s, e: _chunk_mask(lines[:, s:e], gx, gy, thresh, num_registers))


def epipolar_flash_attention(q, k, v, lines, *, t: int, h: int, w: int, downsample: int, num_registers: int,
                             scale: Optional[float] = None, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                             tile_any: Optional[torch.Tensor] = None, kernel: bool = True):
    """Epipolar attention with the in-kernel mask (the JAX contract), through
    `_Epipolar`.

    q: (B, Lq, H, D); Lq need not be t*h*w (the adaptor's learned queries
    attend over 1 + n_ctx key frames), lines carry one row per query.
    k, v: (B, t*h*w + num_registers, H, D), the register tokens last.
    lines: (B, Lq, t, 3) from `epipolar_lines`. tile_any: (B, Lq/block_q,
    nK*nsub) from `epipolar_tile_map` with the same block_q/block_k (its
    trailing block_k tile holds the register column), built for the kernels
    when absent.

    CPU tensors take the plain twins; CUDA tensors launch K6 + K7 (bf16,
    head dim a multiple of 16 up to 128, else they raise) unless `kernel` is
    False (the seam's plain route). A layout that block_q / block_k do not
    tile raises on every route."""
    b, lq, heads, d = q.shape
    hw = h * w
    thw = t * hw
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if lines.shape != (b, lq, t, 3):
        raise ValueError(f"epipolar_flash_attention: lines {tuple(lines.shape)} vs {(b, lq, t, 3)}")
    if lk != thw + num_registers or not 0 <= num_registers <= block_k:
        raise ValueError(f"epipolar_flash_attention: Lk {lk} != t*h*w + num_registers = {thw + num_registers} "
                         f"or registers {num_registers} outside [0, block_k]")
    if not (hw % block_k == 0 or (block_k % hw == 0 and thw % block_k == 0)) or lq % block_q:
        raise ValueError(f"epipolar_flash_attention: block_k {block_k} does not tile hw {hw} x t {t}, "
                         f"or Lq {lq} is not a multiple of block_q {block_q}")
    kernel = ops.on_card(q, "epipolar_flash_attention") and kernel
    geom = dict(t=t, h=h, w=w, downsample=downsample, num_registers=num_registers, scale=scale,
                block_q=block_q, block_k=block_k)
    if kernel and tile_any is None:
        tile_any = epipolar_tile_map(lines, t, h, w, downsample, block_q, block_k)
    return _Epipolar.apply(q, k, v, lines, tile_any, geom, kernel)


class _Epipolar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lines, tile_any, geom, kernel):
        want_lse = any(ctx.needs_input_grad[:3])
        twin_geom = {n: geom[n] for n in ("t", "h", "w", "downsample", "num_registers", "scale")}
        if kernel:
            out, lse = _launch_fwd(q, k, v, lines, tile_any, geom, want_lse=want_lse)
        else:
            out, lse = epipolar_attention_plain(q, k, v, lines, return_lse=True, **twin_geom)
        ctx.kernel, ctx.geom, ctx.twin_geom = kernel, geom, twin_geom
        if want_lse:
            ctx.save_for_backward(q, k, v, lines, tile_any, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lines, tile_any, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if ctx.kernel:
            dq, dk, dv = epipolar_flash_bwd(q, k, v, lines, tile_any, out, lse, dout, ctx.geom)
        else:
            dq, dk, dv = epipolar_bwd_plain(q, k, v, lines, out, lse, dout, **ctx.twin_geom)
        return dq, dk, dv, None, None, None, None


def _kernel_args(q, k, v, lines, tile_any, geom, what):
    """K6/K7's contract: (lines f32, tile map int32, sub, cols, scale as bf16,
    thresh) after the checks."""
    b, lq, heads, d = q.shape
    t, h, w, block_q, block_k = geom["t"], geom["h"], geom["w"], geom["block_q"], geom["block_k"]
    hw = h * w
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous bf16 on {q.device}")
    lk = k.shape[1]
    if k.shape != (b, lk, heads, d) or v.shape != (b, lk, heads, d):
        raise ValueError(f"{what}: k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    sub = min(SUBTILE, block_k, hw)
    if (not head_dim_ok(d) or hw % KERNEL_BK or sub % KERNEL_BK or block_q % KERNEL_BQ
            or geom["num_registers"] > KERNEL_BK):
        raise ValueError(f"{what}: K6/K7 need a head dim that is a multiple of 16 up to 128 "
                         f"(got {d}), 64-key tiles inside one frame and one subtile (hw {hw}, subtile {sub}), "
                         f"block_q a multiple of 64 (got {block_q}) and at most 64 registers")
    if tile_any is None:
        tile_any = epipolar_tile_map(lines, t, h, w, geom["downsample"], block_q, block_k)
    cols = (t * hw + block_k) // sub
    if tile_any.shape != (b, lq // block_q, cols):
        raise ValueError(f"{what}: tile_any {tuple(tile_any.shape)} vs {(b, lq // block_q, cols)}"
                         " (built for another tiling?)")
    scale_bf16 = float(torch.tensor(geom["scale"], dtype=torch.bfloat16))
    thresh = geom["downsample"] * math.sqrt(2.0) / 2.0
    return (lines.to(torch.float32).contiguous(), tile_any.to(torch.int32).contiguous(), sub, cols, scale_bf16,
            thresh)


def _launch_fwd(q, k, v, lines, tile_any, geom, *, want_lse: bool):
    """K6: (out, lse (B, H, Lq) f32 when `want_lse`, else None)."""
    lines, tile_any, sub, cols, scale_bf16, thresh = _kernel_args(q, k, v, lines, tile_any, geom,
                                                                  "epipolar_flash_attention")
    b, lq, heads, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, lq, dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.load("epipolar_flash").epipolar_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lines.data_ptr(), tile_any.data_ptr(), out.data_ptr(),
             _ptr(lse), b, lq, k.shape[1], heads, d, geom["t"], geom["h"] * geom["w"], geom["w"],
             geom["num_registers"], geom["block_q"], sub, cols, scale_bf16, float(geom["downsample"]), thresh,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "epipolar_flash_attention")
    ops.LAUNCHES["epipolar_flash"] += 1
    return out, lse


def epipolar_flash_bwd(q, k, v, lines, tile_any, out, lse, dout, geom):
    """K7: (dq, dk, dv) bf16 from K6's out and lse (B, H, Lq) and dout; geom
    as `epipolar_flash_attention` takes it (t, h, w, downsample,
    num_registers, scale, block_q, block_k)."""
    lines, tile_any, sub, cols, scale_bf16, thresh = _kernel_args(q, k, v, lines, tile_any, geom,
                                                                  "epipolar_flash_bwd")
    b, lq, heads, d = q.shape
    if dout.shape != q.shape or dout.dtype != torch.bfloat16 or not dout.is_contiguous():
        raise ValueError(f"epipolar_flash_bwd: dout {tuple(dout.shape)} {dout.dtype} vs q {tuple(q.shape)}")
    if lse.shape != (b, heads, lq) or lse.dtype != torch.float32:
        raise ValueError(f"epipolar_flash_bwd: lse {tuple(lse.shape)} {lse.dtype} (needs f32 (B, H, Lq))")
    delta = _delta(out, dout)
    qs = q * torch.tensor(geom["scale"], dtype=q.dtype)  # the JAX backward's pre-scaled queries
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.load("epipolar_bwd").epipolar_flash_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    err = fn(qs.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             lines.data_ptr(), tile_any.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             b, lq, k.shape[1], heads, d, geom["t"], geom["h"] * geom["w"], geom["w"], geom["num_registers"],
             geom["block_q"], sub, cols, scale_bf16, float(geom["downsample"]), thresh,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "epipolar_flash_bwd")
    ops.LAUNCHES["epipolar_bwd"] += 1
    return dq, dk, dv


def mask_pairs(lines: torch.Tensor, *, heads: int, t: int, h: int, w: int, downsample: int,
               num_registers: int) -> int:
    """Query-key pairs whose mask bit is set, registers included (times
    heads): the work the masked attention needs for these lines, which K6's
    bound counts. Chunked over queries like the twin."""
    b, lq = lines.shape[:2]
    if lines.shape[2:] != (t, 3):
        raise ValueError(f"mask_pairs: lines {tuple(lines.shape)} vs {(b, lq, t, 3)}")
    gx, gy = _pixel_grid(h, w, downsample, lines.device)
    thresh = downsample * math.sqrt(2.0) / 2.0
    frame = sum(int(_distance_mask(lines[:, s:s + TWIN_CHUNK].float(), gx, gy, thresh).sum())
                for s in range(0, lq, TWIN_CHUNK))
    return (frame + b * lq * num_registers) * heads


def visible_pairs(tile_any: torch.Tensor, *, heads: int, t: int, hw: int, num_registers: int,
                  block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> int:
    """Query-key pairs inside subtiles the map leaves visible (times heads):
    the work K6 does for these inputs after skipping."""
    sub = min(SUBTILE, block_k, hw)
    frame_cols = t * hw // sub
    frame = int(tile_any[..., :frame_cols].sum()) * block_q * sub
    regs = int(tile_any[..., frame_cols].sum()) * block_q * num_registers
    return (frame + regs) * heads
