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
position). NaN lines (F == 0) hide their whole key frame and fully masked
rows give 0. The keys are not padded to a tile.

The geometry helpers (`epipolar_lines`, `epipolar_tile_map`,
`materialize_mask`, the tiling rules) are exact ports of the JAX functions,
held to the JAX package bit for bit by the CPU tests. Every mask distance is
formed in one operation order, `(a*px + b*py) + c` with each product and sum
rounded to f32 (eager torch elementwise ops here, `__fmul_rn`/`__fadd_rn` in
the kernel), so the kernel and its twin agree on every bit.

Two tilings. The canonical one (BLOCK_Q, BLOCK_K, SUBTILE: the JAX
package's) decides, by the JAX rule, which levels take the in-kernel mask
(`choose_block_k`, `kernel_tiling_ok`) and names their layout. The kernels
run on the Hopper core's 128-query x 64-key tiles (`csrc/flash_hopper.cuh`)
and skip the tiles that the hull map built at that tiling marks empty
(`kernel_tile_map`: the same JAX rule at block_q = 128, block_k = 64, the
register column at t*h*w / 64); that map is the kernels' contract.

K7 (`csrc/epipolar_bwd.cu`) replaces the Pallas kernels `_v2_bwd_dq_kernel`
/ `_v2_bwd_dkv_kernel` (`_epipolar_flash_bwd_impl`, the custom VJP of
`epipolar_flash_attention`): dq, dk, dv from K6's logsumexp with the mask
bits recomputed from the lines by the same policy (`csrc/epipolar_mask.cuh`)
and the same tile skips; its pre-pass kernel forms qs = bf16(q * scale) and
delta on the card (`bwd_prepass_plain` is its plain version). K6 and K7 are
the Hopper core's forward and backward bodies (`csrc/flash_hopper_kernels.cuh`),
K2's and K5's, under the line-mask policy. `epipolar_flash_attention` runs
`_Epipolar`: K6 (with the lse when a gradient is wanted) and K7, or the plain
twins; lines and tile map get no gradient.

K6p (`csrc/epipolar_precomp.cu`) replaces `_v2p_kernel`, the path of
`epipolar_flash_attention(..., penalties=)`: the Hopper core's forward body
under a third mask policy (`PenaltyMask`, `csrc/epipolar_mask.cuh`): each
frame key's logit raised by its bf16 additive penalty (0 / -1e30 from
`materialize_penalties`, built once per request), the 128 x 64 penalty tile
streamed by TMA into the ring beside K and V, the same skip map as K6. The
port's penalties cover the t*hw frame keys only, (pb, Lq, t*hw); the
register keys stay always visible, as in K6, so the keys are not padded
(the JAX array carries a trailing block_k tile of register and padding
columns). Batch b reads penalty batch b % pb: the fused-CFG batch of 2B
shares one copy. The penalties are an inference-path option: with a
gradient wanted, the backward is K7's (or its twin's), on the lines' mask,
as in the JAX package.

The least time the function needs counts 4*D operations per query-key pair
whose mask bit is set (`mask_pairs`; the backward 10*D); the work K6 does
after skipping counts every pair of the tiles the map leaves on
(`visible_pairs`). K6p's bound adds the bytes of the penalty tiles the map
leaves on (`visible_penalty_bytes`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build
from camc2v_tpu_torch.ops import flash_attention as fa
from camc2v_tpu_torch.ops.flash_attention import LSE_MASKED, _bf16, _ptr, attention_bwd_plain

# canonical tiling of the tile maps (the JAX package's, so maps agree bit for
# bit): 256-query rows, 1024-key tiles, skip granularity SUBTILE
BLOCK_Q = 256
BLOCK_K = 1024
SUBTILE = 256
NEG_INF = -1e30
M_FLOOR = -1e20
# the kernels' query and key tiles (BQ, BK in csrc/flash_hopper.cuh, K2's
# too): the tile map the kernels read is built at this tiling (`kernel_tile_map`)
KERNEL_BQ = fa.BLOCK_Q
KERNEL_BK = fa.BLOCK_K
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


def kernel_tile_map(lines: torch.Tensor, t: int, h: int, w: int, downsample: int) -> torch.Tensor:
    """(B, Lq/128, t*h*w/64 + 1) int32: `epipolar_tile_map` at the kernels'
    own tiling (KERNEL_BQ queries x KERNEL_BK keys, the register column
    last), the map K6, K6p and K7 read to skip their empty tiles. Its hull
    rule needs 64-key subtiles of whole image rows (w dividing 64); the
    kernel wrappers check that."""
    return epipolar_tile_map(lines, t, h, w, downsample, KERNEL_BQ, KERNEL_BK)


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
    gx, gy = _pixel_grid(h, w, downsample, q.device)
    thresh = downsample * math.sqrt(2.0) / 2.0

    def masked(logits, s, e):
        mask = _chunk_mask(lines[:, s:e], gx, gy, thresh, num_registers)[:, None]
        return torch.where(mask, logits, NEG_INF)

    return _chunked_attention(q, k, v, masked, scale, return_lse)


def epipolar_attention_precomp_plain(q, k, v, penalties, *, t: int, h: int, w: int, scale: Optional[float] = None):
    """Plain twin of K6p: K6's twin with the frame keys' logits raised by
    their additive penalties (pb, Lq, t*h*w), batch b reading penalty batch
    b % pb (the JAX `_v2p_kernel` arithmetic); the register keys after the
    frames stay visible."""
    b, pb, thw = q.shape[0], penalties.shape[0], t * h * w
    reps = b // pb

    def penalised(logits, s, e):
        pen = penalties[:, s:e].float().repeat(reps, 1, 1)[:, None]  # (B, 1, c, thw)
        return torch.cat([logits[..., :thw] + pen, logits[..., thw:]], dim=-1)

    return _chunked_attention(q, k, v, penalised, scale, False)


def _chunked_attention(q, k, v, mask_logits, scale, return_lse):
    """The twins' attention over query chunks; `mask_logits(logits, s, e)`
    applies the mask of queries [s, e) to their (B, H, c, Lk) f32 logits."""
    b, lq, heads, d = q.shape
    if scale is None:
        scale = d ** -0.5
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, lq, dtype=torch.float32, device=q.device) if return_lse else None
    for s in range(0, lq, TWIN_CHUNK):
        e = min(lq, s + TWIN_CHUNK)
        logits = mask_logits(torch.einsum("bqhd,bkhd->bhqk", qs[:, s:e], kf), s, e)
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


def materialize_penalties(lines: torch.Tensor, t: int, h: int, w: int, downsample: int) -> torch.Tensor:
    """(B, Lq, t*h*w) additive penalties, 0 where the mask bit is set and
    -1e30 where it is not: K6p's input, built once per request (the JAX
    `materialize_penalties` without its trailing register/padding tile;
    bf16 holds -1e30). Chunked over queries like the twin."""
    b, lq = lines.shape[:2]
    gx, gy = _pixel_grid(h, w, downsample, lines.device)
    thresh = downsample * math.sqrt(2.0) / 2.0
    out = torch.empty(b, lq, t * h * w, dtype=torch.bfloat16, device=lines.device)
    zero = torch.zeros((), dtype=torch.bfloat16, device=lines.device)
    hidden = torch.full((), NEG_INF, dtype=torch.bfloat16, device=lines.device)
    for s in range(0, lq, TWIN_CHUNK):
        out[:, s:s + TWIN_CHUNK] = torch.where(_distance_mask(lines[:, s:s + TWIN_CHUNK].float(), gx, gy, thresh),
                                               zero, hidden)
    return out


def epipolar_flash_attention(q, k, v, lines, *, t: int, h: int, w: int, downsample: int, num_registers: int,
                             scale: Optional[float] = None, block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                             tile_any: Optional[torch.Tensor] = None, penalties: Optional[torch.Tensor] = None,
                             kernel: bool = True):
    """Epipolar attention with the in-kernel mask (the JAX contract), through
    `_Epipolar`.

    q: (B, Lq, H, D); Lq need not be t*h*w (the adaptor's learned queries
    attend over 1 + n_ctx key frames), lines carry one row per query.
    k, v: (B, t*h*w + num_registers, H, D), the register tokens last.
    lines: (B, Lq, t, 3) from `epipolar_lines`. block_q / block_k name the
    layout's canonical tiling (`choose_block_k`). tile_any: the kernels' map
    from `kernel_tile_map` (built when absent; the plain twins do not read
    it). penalties: (pb, Lq, t*h*w) from `materialize_penalties`, b % pb ==
    0, in place of the line-distance mask (K6p).

    CPU tensors take the plain twins; CUDA tensors launch K6 (or K6p) + K7
    (bf16, head dim a multiple of 16 up to 128, else they raise) unless
    `kernel` is False (the seam's plain route). A layout that block_q /
    block_k do not tile raises on every route."""
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
    if penalties is not None and (penalties.dim() != 3 or penalties.shape[1:] != (lq, thw)
                                  or b % penalties.shape[0]):
        raise ValueError(f"epipolar_flash_attention: penalties {tuple(penalties.shape)} vs (pb, {lq}, {thw}) "
                         f"with {b} % pb == 0")
    kernel = ops.on_card(q, "epipolar_flash_attention") and kernel
    geom = dict(t=t, h=h, w=w, downsample=downsample, num_registers=num_registers, scale=scale,
                block_q=block_q, block_k=block_k)
    if kernel and tile_any is None:
        tile_any = kernel_tile_map(lines, t, h, w, downsample)
    return _Epipolar.apply(q, k, v, lines, tile_any, penalties, geom, kernel)


class _Epipolar(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lines, tile_any, penalties, geom, kernel):
        want_grad = any(ctx.needs_input_grad[:3])
        twin_geom = {n: geom[n] for n in ("t", "h", "w", "downsample", "num_registers", "scale")}
        ctx.kernel, ctx.geom, ctx.twin_geom = kernel, geom, twin_geom
        if penalties is not None:
            twin = lambda q_, k_, v_, pen: epipolar_attention_precomp_plain(  # noqa: E731
                q_, k_, v_, pen, t=geom["t"], h=geom["h"], w=geom["w"], scale=geom["scale"])
            run = (lambda q_, k_, v_, pen: _launch_precomp(q_, k_, v_, lines, pen, tile_any, geom)) if kernel \
                else twin
            # a gradient's forward is a dispatcher op, so a remat policy can save it
            out = ops.saved_forward(run, twin, q, k, v, penalties) if want_grad else run(q, k, v, penalties)
            if want_grad:  # the backward re-derives the lse from the lines
                ctx.save_for_backward(q, k, v, lines, tile_any, None, None)
            return out
        twin = lambda q_, k_, v_, l_, ta: epipolar_attention_plain(  # noqa: E731
            q_, k_, v_, l_, return_lse=True, **twin_geom)
        if kernel:
            run = lambda q_, k_, v_, l_, ta: _launch_fwd(q_, k_, v_, l_, ta, geom, want_lse=want_grad)  # noqa: E731
        else:
            run = twin
        out, lse = ops.saved_forward(run, twin, q, k, v, lines, tile_any) if want_grad else \
            run(q, k, v, lines, tile_any)
        if want_grad:
            ctx.save_for_backward(q, k, v, lines, tile_any, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lines, tile_any, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        if lse is None:  # the penalties' forward: recompute on the lines' mask
            if ctx.kernel:
                out, lse = _launch_fwd(q, k, v, lines, tile_any, ctx.geom, want_lse=True)
            else:
                out, lse = epipolar_attention_plain(q, k, v, lines, return_lse=True, **ctx.twin_geom)
        if ctx.kernel:
            dq, dk, dv = epipolar_flash_bwd(q, k, v, lines, tile_any, out, lse, dout, ctx.geom)
        else:
            dq, dk, dv = epipolar_bwd_plain(q, k, v, lines, out, lse, dout, **ctx.twin_geom)
        return dq, dk, dv, None, None, None, None, None


def _kernel_args(q, k, v, lines, tile_any, geom, what):
    """K6/K6p/K7's contract, checked: (tile map int32 at the kernels' tiling,
    its columns, scale rounded to bf16, thresh)."""
    b, lq, heads, d = q.shape
    t, h, w = geom["t"], geom["h"], geom["w"]
    hw = h * w
    if not q.is_cuda:
        raise ValueError(f"{what}: unsupported device {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{what}: {name} must be contiguous bf16 on {q.device}")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must start on a 16-byte boundary (the kernels copy it by TMA)")
    lk = k.shape[1]
    if k.shape != (b, lk, heads, d) or v.shape != (b, lk, heads, d):
        raise ValueError(f"{what}: k/v {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if (not head_dim_ok(d) or hw % KERNEL_BK or KERNEL_BK % w or lq % KERNEL_BQ
            or geom["num_registers"] > KERNEL_BK):
        raise ValueError(f"{what}: the kernels need a head dim that is a multiple of 16 up to 128 (got {d}), "
                         f"64-key tiles of whole image rows inside one frame (hw {hw}, w {w}), Lq a multiple "
                         f"of {KERNEL_BQ} (got {lq}) and at most {KERNEL_BK} registers")
    if tile_any is None:
        tile_any = kernel_tile_map(lines, t, h, w, geom["downsample"])
    cols = t * hw // KERNEL_BK + 1
    if tile_any.shape != (b, lq // KERNEL_BQ, cols):
        raise ValueError(f"{what}: tile_any {tuple(tile_any.shape)} vs {(b, lq // KERNEL_BQ, cols)}"
                         " (the map at the kernels' tiling, `kernel_tile_map`)")
    thresh = geom["downsample"] * math.sqrt(2.0) / 2.0
    return tile_any.to(torch.int32).contiguous(), cols, _bf16(geom["scale"]), thresh


def _kernel_lines(lines):
    """The lines as the kernels stage them: (B, t, Lq, 3) f32, each frame's
    query rows contiguous."""
    return lines.to(torch.float32).transpose(1, 2).contiguous()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 7 + [_I] * 10 + [_F] * 3 + [_P]
_EPI_BWD_ARGS = [_P] * 14 + [_I] * 10 + [_F] * 3 + [_P]
_PRECOMP_ARGS = [_P] * 6 + [_I] * 10 + [_F, _P]


def _launch_fwd(q, k, v, lines, tile_any, geom, *, want_lse: bool):
    """K6: (out, lse (B, H, Lq) f32 when `want_lse`, else None)."""
    tile_any, cols, scale_bf16, thresh = _kernel_args(q, k, v, lines, tile_any, geom, "epipolar_flash_attention")
    b, lq, heads, d = q.shape
    lines_t = _kernel_lines(lines)
    out = torch.empty_like(q)
    lse = torch.empty(b, heads, lq, dtype=torch.float32, device=q.device) if want_lse else None
    fn = _build.function("epipolar_flash", "epipolar_flash_fwd", _FWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lines_t.data_ptr(), tile_any.data_ptr(), out.data_ptr(),
             _ptr(lse), b, lq, k.shape[1], heads, d, geom["t"], geom["h"] * geom["w"], geom["w"],
             geom["num_registers"], cols, scale_bf16, float(geom["downsample"]), thresh,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "epipolar_flash_attention")
    ops.LAUNCHES["epipolar_flash"] += 1
    return out, lse


def _launch_precomp(q, k, v, lines, penalties, tile_any, geom):
    """K6p: out, the mask read from the (pb, Lq, t*hw) bf16 penalties."""
    b, lq, heads, d = q.shape
    tile_any, cols, scale_bf16, _ = _kernel_args(q, k, v, lines, tile_any, geom,
                                                 "epipolar_flash_attention(penalties)")
    penalties = penalties.contiguous()
    if penalties.dtype != torch.bfloat16 or penalties.device != q.device or penalties.data_ptr() % 16:
        raise ValueError(f"epipolar_flash_attention: penalties must be bf16 on {q.device} on a 16-byte boundary "
                         f"(got {penalties.dtype})")
    out = torch.empty_like(q)
    fn = _build.function("epipolar_precomp", "epipolar_precomp_fwd", _PRECOMP_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), penalties.data_ptr(), tile_any.data_ptr(), out.data_ptr(),
             b, lq, k.shape[1], heads, d, geom["t"], geom["h"] * geom["w"], geom["num_registers"],
             penalties.shape[0], cols, scale_bf16, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "epipolar_flash_attention(penalties)")
    ops.LAUNCHES["epipolar_flash_precomp"] += 1
    return out


def epipolar_flash_bwd(q, k, v, lines, tile_any, out, lse, dout, geom):
    """K7: (dq, dk, dv) bf16 from K6's out and lse (B, H, Lq) and dout; geom
    as `epipolar_flash_attention` takes it (t, h, w, downsample,
    num_registers, scale); the pre-pass (qs, delta) runs on the card inside
    the launch."""
    tile_any, cols, scale_bf16, thresh = _kernel_args(q, k, v, lines, tile_any, geom, "epipolar_flash_bwd")
    b, lq, heads, d = q.shape
    for name, x in (("dout", dout), ("out", out)):
        if x.shape != q.shape or x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"epipolar_flash_bwd: {name} {tuple(x.shape)} {x.dtype} vs q {tuple(q.shape)} (needs "
                             "contiguous bf16 on a 16-byte boundary)")
    if lse.shape != (b, heads, lq) or lse.dtype != torch.float32:
        raise ValueError(f"epipolar_flash_bwd: lse {tuple(lse.shape)} {lse.dtype} (needs f32 (B, H, Lq))")
    lse = lse.contiguous()
    lines_t = _kernel_lines(lines)
    qs = torch.empty_like(q)
    lse_pad, delta = torch.empty_like(lse), torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("epipolar_bwd", "epipolar_flash_bwd", _EPI_BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
             lines_t.data_ptr(), tile_any.data_ptr(), qs.data_ptr(), lse_pad.data_ptr(), delta.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, lq, k.shape[1], heads, d, geom["t"],
             geom["h"] * geom["w"], geom["w"], geom["num_registers"], cols, scale_bf16,
             float(geom["downsample"]), thresh, torch.cuda.current_stream(q.device).cuda_stream)
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


def visible_penalty_bytes(tile_any: torch.Tensor, *, t: int, hw: int, pb: int, block_q: int = BLOCK_Q,
                          block_k: int = BLOCK_K) -> int:
    """Bytes of the bf16 penalty subtiles the map leaves on, each read once
    (a map's rows past the penalties' batch pb read the same penalties):
    what K6p must read of the penalties for these inputs."""
    sub = min(SUBTILE, block_k, hw)
    frame_cols = t * hw // sub
    return int(tile_any[:pb, :, :frame_cols].sum()) * block_q * sub * 2


def visible_pairs(tile_any: torch.Tensor, *, heads: int, t: int, hw: int, num_registers: int,
                  block_q: int = BLOCK_Q, block_k: int = BLOCK_K) -> int:
    """Query-key pairs inside subtiles the map leaves visible (times heads):
    the work K6 does for these inputs after skipping."""
    sub = min(SUBTILE, block_k, hw)
    frame_cols = t * hw // sub
    frame = int(tile_any[..., :frame_cols].sum()) * block_q * sub
    regs = int(tile_any[..., frame_cols].sum()) * block_q * num_registers
    return (frame + regs) * heads
