"""Row LayerNorm with f32 statistics: kernel K8 and its plain twin.

The CUDA kernel (`csrc/layernorm.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/layernorm.py::_ln_kernel` (entry `layer_norm_fused`): per
row of (..., C), the f32 mean and exact two-pass variance over C, then
scale/bias, the output in x's dtype. The op is bound by HBM bytes (x read
once, y written once): a row lives in the registers of the lanes that own
it (`ln_plan`, the partition of `csrc/layernorm.cuh`), which read and write
it with 16-byte accesses. The same row kernel is the LayerNorm pass of K3
and K4.

The model reaches K8 only with `CAMC2V_LN_FUSED=1` (`nn/layers.py::
LayerNormF32`), at the sites `layer_norm_supported` accepts, as the JAX
package does. K8's numerics are the plain path's (two-pass), so the
predicate only picks sites.

Training: the gradient is the vector-Jacobian product of the plain twin
recomputed from the saved inputs (`ops.recompute_grad`, the JAX `_ln_bwd`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build

# the JAX package's VMEM budget (camc2v_tpu/ops/layernorm.py:23): with the
# block-row search below it decides which sites take K8, as on the TPU; the
# CUDA kernel itself takes any row count
_MAX_VMEM_BYTES = 6 * 1024 * 1024


def layer_norm_plain(x, scale, bias, *, eps: float = 1e-5):
    """Plain twin: `camc2v_tpu/ops/layernorm.py::layer_norm_plain` numerics
    (f32 mean, exact two-pass variance, output in x's dtype)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _pick_block_rows(r: int, c: int, itemsize: int) -> int:
    """The JAX `_pick_block_rows`: the largest multiple-of-8 divisor of r
    whose (rows, C) tile fits the TPU budget (0 when none)."""
    per_row = c * (itemsize * 2 + 4)
    bl_max = min(r, max(8, _MAX_VMEM_BYTES // max(per_row, 1)))
    best = 0
    for bl in range(8, bl_max + 1, 8):
        if r % bl == 0:
            best = bl
    return best


def layer_norm_supported(x: torch.Tensor) -> bool:
    """The JAX `layer_norm_supported` (camc2v_tpu/ops/layernorm.py:113): the
    sites that take the fused LayerNorm, from x's shape and dtype."""
    c = x.shape[-1]
    if c < 128 or c % 8 != 0:
        return False
    r = 1
    for s in x.shape[:-1]:
        r *= s
    if r % 8 != 0:
        return False
    return _pick_block_rows(r, c, x.element_size()) >= 8


def layer_norm_fused(x, scale, bias, *, eps: float = 1e-5, kernel: bool = True):
    """LayerNorm over the trailing axis with f32 statistics, x's dtype out,
    through `ops.recompute_grad`. CPU tensors take the plain twin; CUDA
    tensors launch K8 unless `kernel` is False (the seam's plain route)."""
    twin = functools.partial(layer_norm_plain, eps=eps)
    run = functools.partial(_launch, eps=eps) if ops.on_card(x, "layer_norm_fused") and kernel else twin
    return ops.recompute_grad(run, twin, x, scale, bias)


# the row kernel's partition of a row (csrc/layernorm.cuh `launch`)
LN_PIECE_BYTES = 16       # one lane's load: 8 bf16 or 4 f32 channels
LN_THREADS = 256          # a block's threads
LN_TARGET_PER_LANE = 8    # the lanes per row are the fewest that leave a lane at most this many pieces
LN_MAX_PER_LANE = 16      # the most pieces a lane holds (32 lanes: 512 pieces a row)


class LnPlan(NamedTuple):
    lanes: int     # lanes of a warp per row (a power of two)
    per_lane: int  # pieces a lane holds: lane l owns pieces l, l + lanes, ...
    pieces: int    # 16-byte pieces of a row


def ln_plan(c: int, elem: int) -> LnPlan:
    """The row kernel's lanes for a row of c channels of `elem` bytes."""
    pieces = c * elem // LN_PIECE_BYTES
    if c * elem % LN_PIECE_BYTES or not 0 < pieces <= 32 * LN_MAX_PER_LANE:
        raise ValueError(f"layer_norm_fused: C={c} must fill whole 16-byte pieces, at most {32 * LN_MAX_PER_LANE}")
    lanes = 1
    while lanes < 32 and -(-pieces // lanes) > LN_TARGET_PER_LANE:
        lanes *= 2
    return LnPlan(lanes, -(-pieces // lanes), pieces)


_LN_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _launch(x, scale, bias, *, eps: float):
    """K8 on the card (the wrapper's checks, then the ctypes launch)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"layer_norm_fused: dtype {x.dtype} (needs bfloat16 or float32)")
    c = x.shape[-1]
    ln_plan(c, x.element_size())
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.float().contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError("layer_norm_fused: scale/bias must be (C,) on x's device")
    x = x.contiguous()
    if (x.data_ptr() | scale.data_ptr() | bias.data_ptr()) % LN_PIECE_BYTES:
        raise ValueError("layer_norm_fused: x, scale and bias must start on 16-byte boundaries")
    y = torch.empty_like(x)
    rows = x.numel() // c
    if rows == 0:
        return y
    err = _build.function("layernorm", "ln_forward", _LN_ARGS)(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c, float(eps),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "layernorm")
    ops.LAUNCHES["layernorm"] += 1
    return y
