"""GroupNorm(+SiLU) over channels-last maps: kernel K1 and its plain twin.

The CUDA kernel (`csrc/groupnorm.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/groupnorm.py::_gn_kernel` (entry `group_norm_fused`). It
computes per (sample, group) f32 statistics over every spatial position and
the group's channels, with the exact two-pass variance, then applies
scale/bias and the optional SiLU.

On the H100 the op is bound by HBM bytes: three reads of x (sum, squared
deviation, apply) and one write. The TPU kernel kept a whole sample in VMEM
(its 6 MB `_MAX_VMEM_BYTES` bound); a Hopper block cannot, so the kernel
splits each sample's rows over many blocks (coalesced rows of all C
channels), writes per-(sample, split, group) partial sums to a small f32
workspace, and every later launch re-reduces those partials. This covers
every GroupNorm32 site of the model, 4-D and 5-D, the VAE's 256x256 maps
included.

Training: the seam's gradient is the vector-Jacobian product of the plain
twin recomputed from the saved input (`ops.recompute_grad`), the JAX
`_group_norm` custom VJP; K1 has no backward kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build


def group_norm_plain(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """Plain twin: `camc2v_tpu/ops/groupnorm.py::group_norm_plain` numerics
    (per-channel f32 means, then group means; exact two-pass variance)."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xf = x.reshape(n, -1, c).float()
    s1 = xf.mean(dim=1)  # (n, C)
    mean_c = s1.view(n, num_groups, cg).mean(-1).repeat_interleave(cg, dim=-1)
    d = xf - mean_c[:, None]
    v = (d * d).mean(dim=1)
    inv_c = torch.rsqrt(v.view(n, num_groups, cg).mean(-1) + eps).repeat_interleave(cg, dim=-1)
    y = d * inv_c[:, None]
    y = y * scale.float() + bias.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape).to(orig_dtype)


def _splits(n: int, rows: int) -> int:
    """Row blocks per sample: about 4 blocks per SM over the 132 SMs, with at
    least 32 rows each."""
    want = max(1, (4 * 132 + n - 1) // n)
    return max(1, min(want, rows // 32))


def group_norm_fused(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                     kernel: bool = True):
    """GroupNorm over (N, ..., C): stats per (sample, group) over all middle
    dims, through `ops.recompute_grad`. CPU tensors take the plain twin;
    CUDA tensors launch K1 unless `kernel` is False (the seam's plain route)."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    twin = functools.partial(group_norm_plain, **kw)
    run = functools.partial(_launch, **kw) if ops.on_card(x, "group_norm_fused") and kernel else twin
    return ops.recompute_grad(run, twin, x, scale, bias)


def _launch(x, scale, bias, *, num_groups: int, eps: float, silu: bool):
    """K1 on the card (the wrapper's checks, then the ctypes launch)."""
    if not x.is_cuda:
        raise ValueError(f"group_norm_fused: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_fused: dtype {x.dtype} (needs bfloat16 or float32)")
    if not x.is_contiguous():
        raise ValueError("group_norm_fused: x must be contiguous")
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups or c % 2:
        raise ValueError(f"group_norm_fused: C={c} must be even and divisible by groups={num_groups}")
    rows = x.numel() // (n * c)
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device:
        raise ValueError("group_norm_fused: scale/bias must be (C,) on x's device")
    split = _splits(n, rows)
    y = torch.empty_like(x)
    ws = torch.empty(2 * n * split * num_groups, device=x.device, dtype=torch.float32)
    lib = _build.load("groupnorm")
    fn = lib.gn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
             n, rows, c, num_groups, split, float(eps), int(silu),
             int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "groupnorm")
    ops.LAUNCHES["groupnorm"] += 1
    return y


def group_norm(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """The model's GroupNorm seam: K1 where `ops.route` picks it, the twin
    elsewhere."""
    kernel = ops.route(x, takes=(torch.bfloat16, torch.float32))
    return group_norm_fused(x.contiguous() if kernel else x, scale, bias, num_groups=num_groups, eps=eps,
                            silu=silu, kernel=kernel)
