"""Fused short-sequence (temporal) multi-head self-attention: kernel K3.

The CUDA kernels (`csrc/temporal_attention.cu`) replace the Pallas kernel
`camc2v_tpu/ops/temporal_attention.py::_kernel` (entry `fused_temporal_mha`):
optional f32 LayerNorm, the [Wq|Wk|Wv] projection, per-head
softmax(q k^T / sqrt(d)) v over T tokens, the out-projection with bias and an
optional f32 residual.

On the H100 the projections carry ~95% of the operations, so K3 is GEMMs on
the wgmma/TMA core (`csrc/gemm_hopper.cuh`), one ctypes entry with up to
three launches: the row LayerNorm to scratch (when fused); one GEMM whose
tile is (128 rows, head) with head h's [q|k|v] as its 192 columns and whose
epilogue runs the attention of the tile's whole sequences (block-diagonal
mask on a 64 x 64 wgmma score tile per warpgroup) and writes o_h to scratch;
the out-projection GEMM with bias and residual (`ops/_gemm.py`). The tiling
needs T to divide the 64 rows of a warpgroup, so K3 takes T in {1, 2, 4, 8,
16, 32} and head dim 64; `nn/attention.py::_fused_mha_ok` sends other T to
the plain route, as the JAX package sends T that does not divide 128 (its
`supported`). Every self-attention of the model over at most 32 tokens has
T = 16 and head dim 64 (the temporal transformers at every level, the
spatial self-attention at the 4x4 level).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build
from camc2v_tpu_torch.ops._gemm import BLOCK_K, out_splits, sm_count, workspace

# the QKV-and-attention GEMM's tiling (`csrc/temporal_attention.cu`)
WG_ROWS = 64     # rows of a warpgroup's attention tile: whole sequences
HEAD_DIM = 64    # the one head dim the kernels take (D)
QKV_STAGES = 4   # its ring depth (the source's default)
MAX_T = 32       # the longest sequence K3 takes; the model routes longer self-attention to K2


def seq_ok(t: int) -> bool:
    """K3 takes sequences of T tokens: whole sequences in a warpgroup's rows."""
    return 1 <= t <= MAX_T and WG_ROWS % t == 0


def supported(t: int, c_in: int, c_out: int, dim_head: int) -> bool:
    """Static eligibility of K3 for an (N, T, C) problem: T | 64, whole
    k-stages of C_in, 16-byte output rows, head dim 64."""
    return seq_ok(t) and c_in % BLOCK_K == 0 and c_out % 8 == 0 and dim_head == HEAD_DIM


def _maybe_ln(x, ls, lb, eps):
    if ls is None:
        return x.to(torch.bfloat16), None
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * ls.float() + lb.float()
    return xn.to(torch.bfloat16), xf


def mha_plain(x, wq, wk, wv, wo, bo, ls=None, lb=None, *, heads: int, scale: float,
              residual: bool = False, eps: float = 1e-5):
    """Plain twin of `_mha_xla`; weights in the torch Linear layout, used as
    bf16 (the JAX path merges them into one bf16 (C, 3*inner) matrix)."""
    n, t, _ = x.shape
    inner = wq.shape[0]
    dim_head = inner // heads
    xb, xf = _maybe_ln(x, ls, lb, eps)
    wqkv = torch.cat([wq, wk, wv]).to(torch.bfloat16)
    qkv = (xb.float() @ wqkv.float().t()).to(torch.bfloat16)
    q, k, v = (a.reshape(n, t, heads, dim_head) for a in qkv.split(inner, dim=-1))
    s = torch.einsum("nthd,nshd->nhts", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    o = torch.einsum("nhts,nshd->nthd", p.float(), v.float()).to(torch.bfloat16).reshape(n, t, inner)
    out = o.float() @ wo.to(torch.bfloat16).float().t() + bo.float()
    if residual:
        out = out + (xf if xf is not None else x.float())
    return out.to(x.dtype)


def fused_temporal_mha(x, wq, wk, wv, wo, bo, *, heads: int, scale: Optional[float] = None,
                       ln_scale=None, ln_bias=None, residual: bool = False, eps: float = 1e-5):
    """Fused MHA over (N, T, C) with T small.

    wq/wk/wv: (H*D, C) and wo: (C_out, H*D) in the torch Linear layout;
    bo: (C_out,). ln_scale/ln_bias: fuse an f32 LayerNorm of the raw x.
    residual adds the raw x (needs C_out == C). CPU tensors take the plain
    twin; CUDA tensors launch K3. The call goes through `ops.recompute_grad`:
    the backward is the vjp of the plain twin, the JAX `_fused` / `_fused_ln`
    custom VJP (K3 has no backward kernel)."""
    inner = wq.shape[0]
    if scale is None:
        scale = (inner // heads) ** -0.5
    if residual and wo.shape[0] != x.shape[-1]:
        raise ValueError("fused_temporal_mha: residual needs C_out == C_in")
    kw = dict(heads=heads, scale=scale, residual=residual, eps=eps)
    twin = functools.partial(mha_plain, **kw)
    run = functools.partial(_launch, **kw) if ops.on_card(x, "fused_temporal_mha") else twin
    return ops.recompute_grad(run, twin, x, wq, wk, wv, wo, bo, ln_scale, ln_bias)


def _launch(x, wq, wk, wv, wo, bo, ln_scale, ln_bias, *, heads: int, scale: float, residual: bool, eps: float):
    """K3 on the card: the wrapper's checks, the scratch, then the ctypes
    entry (up to three launches, one count)."""
    n, t, c_in = x.shape
    inner = wq.shape[0]
    dim_head = inner // heads
    c_out = wo.shape[0]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_temporal_mha: x must be contiguous bf16")
    if not supported(t, c_in, c_out, dim_head) or inner != heads * dim_head or not 0 < n * t < 2 ** 31:
        raise ValueError(f"fused_temporal_mha: unsupported shape N={n} T={t} C={c_in} C_out={c_out} D={dim_head}")
    ws = [w.to(torch.bfloat16).contiguous() for w in (wq, wk, wv, wo)]
    if any(w.shape != (inner, c_in) for w in ws[:3]) or ws[3].shape != (c_out, inner):
        raise ValueError("fused_temporal_mha: weight shapes do not match x")
    if any(a.data_ptr() % 16 for a in (x, *ws)):
        raise ValueError("fused_temporal_mha: x and the weights must be 16-byte aligned")
    bo = bo.float().contiguous()
    ls = lb = None
    if ln_scale is not None:
        ls, lb = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    out = torch.empty(n, t, c_out, device=x.device, dtype=x.dtype)
    xn = torch.empty(n * t, c_in, device=x.device, dtype=torch.bfloat16) if ls is not None else None
    o = torch.empty(n * t, inner, device=x.device, dtype=torch.bfloat16)
    splits = out_splits(n * t, c_out, inner, sm_count(x.device))
    parts = workspace(splits, n * t, c_out, x.device)
    fn = _build.function("temporal_attention", "temporal_mha_fwd",
                         [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float] * 2
                         + [ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), *(w.data_ptr() for w in ws), bo.data_ptr(),
             0 if ls is None else ls.data_ptr(), 0 if lb is None else lb.data_ptr(), out.data_ptr(),
             0 if xn is None else xn.data_ptr(), o.data_ptr(), 0 if parts is None else parts.data_ptr(),
             n, t, c_in, heads, dim_head, c_out, splits, float(scale), float(eps), int(residual),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "temporal_attention")
    ops.LAUNCHES["temporal_attention"] += 1
    return out
