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

K9 and K10 (`csrc/groupnorm_twophase.cu`) replace the Pallas kernels
`_gn_row_moments_kernel` + `_gn_apply_kernel` (entry
`group_norm_fused_temporal`) and `_gn_big_kernel` (entry
`group_norm_fused_big`): GroupNorm with statistics per (sample, group) over
a (B, T, ..., C) map, from f32 raw moments with the single-pass variance
max(E[x^2] - E[x]^2, 0), a different numeric from K1's two-pass one. K9 is
two launches (per-row moments, then apply) around a small combine on a
(B, 2, C) array, as the JAX package runs it; K10 is the same function in one
cooperative launch. Their plain twin (`group_norm_temporal_plain`) has the
JAX numerics: per-row f32 moments, the one-hot group combine, the clamp.
Their gradient recomputes the exact two-pass `group_norm_plain` (the JAX
`_gn_bwd`).

The model takes K9 only behind `CAMC2V_GN_TEMPORAL=1` (5-D temporal norms)
and `CAMC2V_GN_BIG4D=1` (large 4-D maps viewed as (N, s, H/s*W, C)), at the
sites the JAX predicates below pick (`nn/layers.py::GroupNorm32`). K10 has
no model caller (as in the JAX package); `chip_smoke.py` reaches it through
its entry.
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


# ------------------------------------------------ site choice (the JAX rule)
# The JAX package's VMEM budget for one sample's map
# (camc2v_tpu/ops/groupnorm.py:28). Here it is not a tiling: K1, K9 and K10
# take any shape. It is the rule by which the JAX GroupNorm32 picks each
# site's numerics (K1's two-pass variance, or K9's single-pass one under the
# switches), so the port copies it, with the predicates, to give every site
# the JAX package's numerics.
_MAX_VMEM_BYTES = 6 * 1024 * 1024


def _fits(x: torch.Tensor, hw: int, c: int) -> bool:
    return hw * c * (x.element_size() * 2 + 4) <= _MAX_VMEM_BYTES


def group_norm_supported(x: torch.Tensor, num_groups: int) -> bool:
    """The JAX `group_norm_supported` (camc2v_tpu/ops/groupnorm.py:401)."""
    c = x.shape[-1]
    if c % num_groups != 0:
        return False
    hw = 1
    for s in x.shape[1:-1]:
        hw *= s
    if not _fits(x, hw, c):
        return False
    return c >= 128 and c % 8 == 0 and hw % 8 == 0


def group_norm_temporal_supported(x: torch.Tensor, num_groups: int) -> bool:
    """The JAX `group_norm_temporal_supported` (camc2v_tpu/ops/groupnorm.py:
    373): (B, T, ..., C) with the per-frame map under the budget."""
    if x.dim() < 4:
        return False
    c = x.shape[-1]
    if c % num_groups != 0 or c < 128 or c % 8 != 0:
        return False
    hw = 1
    for s in x.shape[2:-1]:
        hw *= s
    return hw % 8 == 0 and _fits(x, hw, c)


def group_norm_big_supported(x: torch.Tensor, num_groups: int) -> bool:
    """The JAX `group_norm_big_supported` (camc2v_tpu/ops/groupnorm.py:388),
    the same rule as the temporal one."""
    return group_norm_temporal_supported(x, num_groups)


# ------------------------------------------------------------- K9 and K10
def _one_hot(c: int, num_groups: int, device) -> torch.Tensor:
    """(C, G) f32 one-hot group assignment (the JAX `A`)."""
    cg = c // num_groups
    return (torch.arange(c, device=device)[:, None] // cg
            == torch.arange(num_groups, device=device)[None, :]).float()


def combine_moments(parts: torch.Tensor, count: int, *, num_groups: int, eps: float) -> torch.Tensor:
    """(B, K, 2, C) f32 partial raw moments (sum, sum of squares per channel)
    -> (B, 2, C) f32 per-channel group mean and inverse std; `count` is the
    number of spatial positions per sample. The JAX combine
    (`_fused_temporal_impl`): sums over K, one-hot group matmuls,
    single-pass variance clamped at 0."""
    mom = parts.sum(dim=1)  # (B, 2, C)
    c = mom.shape[-1]
    A = _one_hot(c, num_groups, mom.device)
    n = float(count * (c // num_groups))
    mean_g = (mom[:, 0] @ A) / n
    ex2_g = (mom[:, 1] @ A) / n
    var_g = torch.clamp(ex2_g - mean_g * mean_g, min=0.0)
    return torch.stack([mean_g @ A.T, torch.rsqrt(var_g + eps) @ A.T], dim=1)


def _apply_stats_plain(xf, stats, scale, bias, silu):
    """(B, S, C) f32 rows normalised with (B, 2, C) stats."""
    y = (xf - stats[:, 0:1]) * stats[:, 1:2]
    y = y * scale.float() + bias.float()
    return y * torch.sigmoid(y) if silu else y


def _sequence_view(x):
    """(B, T, ..., C) -> (B, T, HW, C) and (b, t, hw, c)."""
    b, t, c = x.shape[0], x.shape[1], x.shape[-1]
    hw = x[0, 0].numel() // c
    return x.reshape(b, t, hw, c), (b, t, hw, c)


def group_norm_temporal_plain(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """Plain twin of K9 and K10 with the JAX numerics: x (B, T, ..., C),
    per-(B*T)-row f32 raw moments over HW, `combine_moments`, then apply."""
    xv, (b, t, hw, c) = _sequence_view(x)
    xf = xv.float()
    mom = torch.stack([xf.sum(dim=2), (xf * xf).sum(dim=2)], dim=2)  # (B, T, 2, C)
    stats = combine_moments(mom, t * hw, num_groups=num_groups, eps=eps)
    y = _apply_stats_plain(xf.reshape(b, t * hw, c), stats, scale, bias, silu)
    return y.reshape(x.shape).to(x.dtype)


def group_norm_fused_temporal(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                              kernel: bool = True):
    """GroupNorm of (B, T, ..., C) with statistics per (B, group) over
    (T, ...): K9 on the card (unless `kernel` is False, the seam's plain
    route), its plain twin on the CPU; the gradient recomputes the two-pass
    `group_norm_plain`."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    on = ops.on_card(x, "group_norm_fused_temporal") and kernel
    run = functools.partial(_launch_temporal, **kw) if on else functools.partial(group_norm_temporal_plain, **kw)
    return ops.recompute_grad(run, functools.partial(group_norm_plain, **kw), x, scale, bias)


def group_norm_fused_big(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False):
    """The same function as `group_norm_fused_temporal` in one launch (K10)
    on the card; its plain twin on the CPU."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    on = ops.on_card(x, "group_norm_fused_big")
    run = functools.partial(_launch_big, **kw) if on else functools.partial(group_norm_temporal_plain, **kw)
    return ops.recompute_grad(run, functools.partial(group_norm_plain, **kw), x, scale, bias)


def _twophase_args(x, scale, bias, num_groups: int, what: str):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {x.dtype} (needs bfloat16 or float32)")
    if x.dim() < 3:
        raise ValueError(f"{what}: x {tuple(x.shape)} needs (B, T, ..., C)")
    c = x.shape[-1]
    if c % num_groups or c % 2:
        raise ValueError(f"{what}: C={c} must be even and divisible by groups={num_groups}")
    scale = scale.float().contiguous()
    bias = bias.float().contiguous()
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError(f"{what}: scale/bias must be (C,) on x's device")
    return x.contiguous(), scale, bias


def _launch_temporal(x, scale, bias, *, num_groups: int, eps: float, silu: bool):
    """K9: moments launch, the (B, 2, C) combine, apply launch."""
    x, scale, bias = _twophase_args(x, scale, bias, num_groups, "group_norm_fused_temporal")
    _, (b, t, hw, c) = _sequence_view(x)
    n = b * t
    split = _splits(n, hw)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load("groupnorm_twophase")
    ws = torch.empty(n, split, 2, c, device=x.device, dtype=torch.float32)
    fn = lib.gn_row_moments
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    _build.check(fn(x.data_ptr(), ws.data_ptr(), n, hw, c, split, is_bf16, stream), "group_norm_fused_temporal")
    stats = combine_moments(ws.view(b, t * split, 2, c), t * hw, num_groups=num_groups, eps=eps).contiguous()
    y = torch.empty_like(x)
    fn = lib.gn_apply_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    _build.check(fn(x.data_ptr(), stats.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), n, hw, c, t,
                    split, int(silu), is_bf16, stream), "group_norm_fused_temporal")
    ops.LAUNCHES["groupnorm_temporal"] += 1
    return y


def _launch_big(x, scale, bias, *, num_groups: int, eps: float, silu: bool):
    """K10: one cooperative launch."""
    x, scale, bias = _twophase_args(x, scale, bias, num_groups, "group_norm_fused_big")
    _, (b, t, hw, c) = _sequence_view(x)
    rows = t * hw
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib = _build.load("groupnorm_twophase")
    blocks = lib.gn_big_blocks
    blocks.restype = ctypes.c_int
    blocks.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    nb = blocks(b, rows, c, is_bf16)
    if nb < 1:
        raise RuntimeError(f"group_norm_fused_big: {b} samples do not fit one cooperative launch")
    ws = torch.empty(b * (nb + 1) * 2 * c, device=x.device, dtype=torch.float32)
    y = torch.empty_like(x)
    fn = lib.gn_big
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(), b, nb, rows, c,
                    num_groups, float(eps), int(silu), is_bf16, torch.cuda.current_stream(x.device).cuda_stream),
                 "group_norm_fused_big")
    ops.LAUNCHES["groupnorm_big"] += 1
    return y
