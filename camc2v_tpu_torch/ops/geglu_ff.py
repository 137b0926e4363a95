"""Fused LayerNorm + GEGLU feed-forward with residual: kernel K4.

The CUDA kernel (`csrc/geglu_ff.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/geglu_ff.py::_kernel` (entry `fused_ln_geglu_ff`):
`x + fc2(a * gelu_erf(g))` with `[a, g] = LN_f32(x) @ Wp + bp`, both products
inside the kernel and the (rows, 4C) hidden layer kept out of HBM. GELU is
the exact erf (`erff`), as in the JAX plain path `_ff_xla`, not the TPU
kernel's Abramowitz-Stegun polynomial.

On the H100 the op is two chained tensor-core GEMMs bound by how fast the
weights reach the tensor cores: a block keeps its (rows, C) output
accumulator in registers while it streams the hidden dimension in 32-wide
chunks, so it takes every C of the model (320, 640, 1280) — the TPU's 8 MB
resident-weight budget does not carry over.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build


def supported(c_in: int, inner: int, c_out: int) -> bool:
    """Static eligibility of K4: 64-wide k-slices of C, 32-wide hidden
    chunks, and a block's tiles in shared memory up to C = 1280."""
    return c_in == c_out and c_in % 64 == 0 and c_in <= 1280 and inner % 32 == 0


def ff_plain(x, ls, lb, wp, bp, wf, bf, *, inner: int, eps: float):
    """Plain twin of `_ff_xla` over (rows, C); wp (2*inner, C) and wf
    (C_out, inner) in the torch Linear layout, used as bf16."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + eps) * ls.float() + lb.float()
    xb = xn.to(torch.bfloat16)
    h = xb.float() @ wp.to(torch.bfloat16).float().t() + bp.float()
    a, g = h[:, :inner], h[:, inner:]
    gelu = g * 0.5 * (1.0 + torch.erf(g / math.sqrt(2.0)))
    hidden = (a * gelu).to(torch.bfloat16)
    y = hidden.float() @ wf.to(torch.bfloat16).float().t()
    return (y + bf.float() + xf).to(x.dtype)


def fused_ln_geglu_ff(x, ln_scale, ln_bias, wp, bp, wf, bf, *, eps: float = 1e-5):
    """x + fc2(a * gelu_erf(g)), [a, g] = LN(x) @ wp + bp, over (..., C).

    wp: (2*inner, C), wf: (C_out, inner) — the torch Linear layout.
    CPU tensors take the plain twin; CUDA tensors launch K4. The call goes
    through `ops.recompute_grad`: the backward is the vjp of the plain twin,
    the JAX `_fused` custom VJP (K4 has no backward kernel)."""
    inner = wf.shape[1]
    c_out = wf.shape[0]
    x2 = x.reshape(-1, x.shape[-1])
    twin = functools.partial(ff_plain, inner=inner, eps=eps)
    run = functools.partial(_launch, eps=eps) if ops.on_card(x, "fused_ln_geglu_ff") else twin
    out = ops.recompute_grad(run, twin, x2, ln_scale, ln_bias, wp, bp, wf, bf)
    return out.reshape(*x.shape[:-1], c_out)


def _launch(x2, ln_scale, ln_bias, wp, bp, wf, bf, *, eps: float):
    """K4 on the card over (rows, C) (the wrapper's checks, then the ctypes launch)."""
    inner = wf.shape[1]
    rows, c_in = x2.shape
    c_out = wf.shape[0]
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous():
        raise ValueError("fused_ln_geglu_ff: x must be contiguous bf16")
    if not supported(c_in, inner, c_out) or wp.shape != (2 * inner, c_in):
        raise ValueError(f"fused_ln_geglu_ff: unsupported shape C={c_in} inner={inner} C_out={c_out}")
    wp_b = wp.to(torch.bfloat16).contiguous()
    wf_b = wf.to(torch.bfloat16).contiguous()
    f32 = [t.float().contiguous() for t in (ln_scale, ln_bias, bp, bf)]
    out = torch.empty(rows, c_out, device=x2.device, dtype=x2.dtype)
    fn = _build.load("geglu_ff").geglu_ff_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    err = fn(x2.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), wp_b.data_ptr(), f32[2].data_ptr(),
             wf_b.data_ptr(), f32[3].data_ptr(), out.data_ptr(), rows, c_in, inner, c_out, float(eps),
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "geglu_ff")
    ops.LAUNCHES["geglu_ff"] += 1
    return out
