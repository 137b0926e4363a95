"""Fused LayerNorm + GEGLU feed-forward with residual: kernel K4.

The CUDA kernels (`csrc/geglu_ff.cu`) replace the Pallas kernel
`camc2v_tpu/ops/geglu_ff.py::_kernel` (entry `fused_ln_geglu_ff`):
`x + fc2(a * gelu_erf(g))` with `[a, g] = bf16(LN_f32(x)) @ Wp + bp`. GELU is
the exact erf (`erff`), as in the JAX plain path `_ff_xla`, not the TPU
kernel's Abramowitz-Stegun polynomial.

On the H100 the op is bound by its tensor-core operations (24 rows C^2), and
the TPU's one fused block cannot hold a useful tile's output accumulator at
C = 1280. So one ctypes entry enqueues three launches on the caller's stream,
the same design at every C: K8's row LayerNorm writes bf16 `xn` to scratch;
GEMM 1 on the wgmma/TMA core (`csrc/gemm_hopper.cuh`), each tile pairing 128
`a` columns of Wp with their 128 `g` columns, writes the bf16 hidden layer
`a * gelu(g)` to scratch; GEMM 2 adds the bias and the f32 residual. The
wrapper allocates the output and the scratch, and plans GEMM 2's split of K
(`ops/_gemm.py`) from the shape and the card's SM count.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build
from camc2v_tpu_torch.ops._gemm import BLOCK_K, out_splits, sm_count, workspace

HIDDEN_TILE = 128  # hidden columns of a GEMM-1 tile (`csrc/geglu_ff.cu` Geglu::HID): 128 a and 128 g weight rows
GEGLU_STAGES = 4   # GEMM 1's ring depth (the source's default)


def supported(c_in: int, inner: int, c_out: int) -> bool:
    """Static eligibility of K4: whole k-stages of C and whole hidden tiles
    (every model width: C = 320, 512, 640, 1280 with inner = 4C)."""
    return c_in == c_out and c_in % BLOCK_K == 0 and inner % HIDDEN_TILE == 0


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
    """K4 on the card over (rows, C): the wrapper's checks, the scratch, then
    the ctypes entry (three launches, one count)."""
    inner = wf.shape[1]
    rows, c_in = x2.shape
    c_out = wf.shape[0]
    if x2.dtype != torch.bfloat16 or not x2.is_contiguous():
        raise ValueError("fused_ln_geglu_ff: x must be contiguous bf16")
    if not supported(c_in, inner, c_out) or wp.shape != (2 * inner, c_in) or not 0 < rows < 2 ** 31:
        raise ValueError(f"fused_ln_geglu_ff: unsupported shape rows={rows} C={c_in} inner={inner} C_out={c_out}")
    wp_b = wp.to(torch.bfloat16).contiguous()
    wf_b = wf.to(torch.bfloat16).contiguous()
    f32 = [t.float().contiguous() for t in (ln_scale, ln_bias, bp, bf)]
    out = torch.empty(rows, c_out, device=x2.device, dtype=x2.dtype)
    xn = torch.empty(rows, c_in, device=x2.device, dtype=torch.bfloat16)
    hidden = torch.empty(rows, inner, device=x2.device, dtype=torch.bfloat16)
    if any(t.data_ptr() % 16 for t in (x2, wp_b, wf_b)):
        raise ValueError("fused_ln_geglu_ff: x and the weights must be 16-byte aligned")
    splits = out_splits(rows, c_out, inner, sm_count(x2.device))
    ws = workspace(splits, rows, c_out, x2.device)
    fn = _build.function("geglu_ff", "geglu_ff_fwd",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    err = fn(x2.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(), wp_b.data_ptr(), f32[2].data_ptr(),
             wf_b.data_ptr(), f32[3].data_ptr(), out.data_ptr(), xn.data_ptr(), hidden.data_ptr(),
             0 if ws is None else ws.data_ptr(), rows, c_in, inner, c_out, splits, float(eps),
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "geglu_ff")
    ops.LAUNCHES["geglu_ff"] += 1
    return out
