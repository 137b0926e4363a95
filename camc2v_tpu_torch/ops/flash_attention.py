"""Flash attention forward over (B, L, H, D): kernel K2.

The CUDA kernel (`csrc/flash_attention.cu`) replaces the Pallas kernels
`camc2v_tpu/ops/flash_attention.py::_fwd_kernel_nomask` / `_fwd_kernel` /
`_fwd_kernel_sparse` (entry `flash_attention`): online softmax over key
tiles, q pre-scaled in bf16, an optional (B, Lq, Lk) bool mask shared by the
heads, empty mask tiles skipped, keys past Lk masked, fully masked rows 0.
The log-sum-exp output of the TPU kernel feeds only its training backward
(K5) and is not produced here.

Bound on the H100: tensor cores at the long spatial self-attention
(Lq = Lk = 1024 at the UNet's top level), launch and latency at the short
cross-attention keys. The plain twin is `ops/attention.py::xla_attention`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build

# the kernel's query and key tiles (BQ, BK in csrc/flash_attention.cu): the
# non-empty-tile map is built on this grid
BLOCK_Q = 64
BLOCK_K = 64


def flash_supported(q: torch.Tensor) -> bool:
    """Static eligibility: bf16 with a head dim the kernel's tiles take."""
    d = q.shape[-1]
    return q.dtype == torch.bfloat16 and d % 16 == 0 and d <= 128


def flash_attention(q, k, v, *, mask: Optional[torch.Tensor] = None, scale: Optional[float] = None):
    """Attention over (B, L, H, D). mask: (B or 1, Lq, Lk) bool, True = attend.

    CPU tensors take the plain twin; CUDA tensors launch K2."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        from camc2v_tpu_torch.ops.attention import xla_attention

        return xla_attention(q, k, v, bias=None, mask=None if mask is None else mask[:, None], scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be contiguous bf16 on {q.device}")
    if k.shape != (b, lk, h, d) or v.shape != (b, lk, h, d):
        raise ValueError(f"flash_attention: k/v shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if not flash_supported(q):
        raise ValueError(f"flash_attention: head dim {d} (needs a multiple of 16, <= 128)")
    mask_ptr = tile_ptr = 0
    mask_bstride = 0
    tile_any = None
    if mask is not None:
        if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[1:] != (lq, lk) or mask.shape[0] not in (1, b):
            raise ValueError(f"flash_attention: mask {tuple(mask.shape)} {mask.dtype} (needs bool (B|1, Lq, Lk))")
        mask = mask.contiguous()
        mask_bstride = 0 if mask.shape[0] == 1 else lq * lk
        nq, nk = -(-lq // BLOCK_Q), -(-lk // BLOCK_K)
        padded = torch.zeros(mask.shape[0], nq * BLOCK_Q, nk * BLOCK_K, dtype=torch.bool, device=mask.device)
        padded[:, :lq, :lk] = mask
        tile_any = padded.view(-1, nq, BLOCK_Q, nk, BLOCK_K).any(dim=4).any(dim=2)
        tile_any = tile_any.expand(b, nq, nk).contiguous().to(torch.uint8)
        mask_ptr, tile_ptr = mask.data_ptr(), tile_any.data_ptr()
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p]
    scale_bf16 = float(torch.tensor(scale, dtype=torch.bfloat16))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, tile_ptr, out.data_ptr(),
             b, lq, lk, h, d, scale_bf16, mask_bstride, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    ops.LAUNCHES["flash_attention"] += 1
    return out
