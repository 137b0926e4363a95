"""Fused short-sequence (temporal) multi-head self-attention: kernel K3.

The CUDA kernel (`csrc/temporal_attention.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/temporal_attention.py::_kernel` (entry `fused_temporal_mha`):
optional f32 LayerNorm, the merged [Wq|Wk|Wv] projection, per-head
softmax(q k^T / sqrt(d)) v over T tokens, the out-projection with bias and an
optional f32 residual, all in one pass with the projections inside the kernel.

On the H100 the projections carry ~95% of the FLOPs, so the kernel is a
tensor-core GEMM chain whose weights stream from L2 through shared memory;
the TPU's VMEM weight budgets (14/8 MB) and 128-row sequence packing do not
carry over. The model sends every self-attention over at most 32 tokens here
(the temporal transformers at every level, and the spatial self-attention at
the 4x4 level); all of them have T = 16 and head dim 64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build


MAX_T = 32  # the longest sequence K3 takes; the model routes longer self-attention to K2


def supported(t: int, c_in: int, c_out: int, dim_head: int) -> bool:
    """Static eligibility of K3 for an (N, T, C) problem: 64-wide k-slices of
    C_in and 64-column QKV groups, and a block's tiles in shared memory (one
    32-token sequence fits only up to C = 640)."""
    return (1 <= t <= MAX_T and c_in % 64 == 0 and c_out % 16 == 0 and dim_head % 64 == 0
            and (t <= 16 or max(c_in, c_out) <= 640))


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
    """K3 on the card (the wrapper's checks, then the ctypes launch)."""
    n, t, c_in = x.shape
    inner = wq.shape[0]
    dim_head = inner // heads
    c_out = wo.shape[0]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError("fused_temporal_mha: x must be contiguous bf16")
    if not supported(t, c_in, c_out, dim_head):
        raise ValueError(f"fused_temporal_mha: unsupported shape T={t} C={c_in} C_out={c_out} D={dim_head}")
    ws = [w.to(torch.bfloat16).contiguous() for w in (wq, wk, wv, wo)]
    if any(w.shape != (inner, c_in) for w in ws[:3]) or ws[3].shape != (c_out, inner):
        raise ValueError("fused_temporal_mha: weight shapes do not match x")
    bo = bo.float().contiguous()
    ls = lb = None
    if ln_scale is not None:
        ls, lb = ln_scale.float().contiguous(), ln_bias.float().contiguous()
    out = torch.empty(n, t, c_out, device=x.device, dtype=x.dtype)
    fn = _build.load("temporal_attention").temporal_mha_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    err = fn(x.data_ptr(), *(w.data_ptr() for w in ws), bo.data_ptr(),
             0 if ls is None else ls.data_ptr(), 0 if lb is None else lb.data_ptr(), out.data_ptr(),
             n, t, c_in, heads, dim_head, c_out, float(scale), float(eps), int(residual),
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "temporal_attention")
    ops.LAUNCHES["temporal_attention"] += 1
    return out
