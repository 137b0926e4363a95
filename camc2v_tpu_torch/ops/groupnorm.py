"""GroupNorm(+SiLU) over channels-last maps: kernel K1 and its plain twin.

The CUDA kernel (`csrc/groupnorm.cu`) replaces the Pallas kernel
`camc2v_tpu/ops/groupnorm.py::_gn_kernel` (entry `group_norm_fused`). It
computes per (sample, group) f32 statistics over every spatial position and
the group's channels, with the exact two-pass variance, then applies
scale/bias and the optional SiLU.

On the H100 the op is bound by HBM bytes (x read once, y written once).
The TPU kernel kept a whole sample in VMEM; a Hopper block holds at most
227 KB, so `norm_plan` cuts each sample's rows into slices, one block's
shared memory each. Every block runs a local two-pass over its slice and
the slices' (count, mean, M2) merge by Chan's formula in slice order
(bit-identical on repeat). The slices follow from a sample's shape alone,
so a sample gives the same bits alone and in any batch (the VAE encodes
the same frames beside 2 or 4 context frames). Where a sample fits a cluster of at most 8
blocks (every 4-D UNet site) K1 is one launch: the cluster's blocks read
each other's group sums through distributed shared memory and normalise
their slices from shared memory, so x is read once. Larger samples (the
5-D sites down to ds4, the VAE's maps) take two launches: statistics,
whose last block per sample merges the slices on the card (as K9), then
K9's apply kernel.

Training: the seam's gradient is the vector-Jacobian product of the plain
twin recomputed from the saved input (`ops.recompute_grad`), the JAX
`_group_norm` custom VJP; K1 has no backward kernel.

K9 (`csrc/groupnorm_twophase.cu`) replaces the Pallas kernels
`_gn_row_moments_kernel` + `_gn_apply_kernel` (entry
`group_norm_fused_temporal`): GroupNorm with statistics per (sample, group)
over a (B, T, ..., C) map, from f32 raw moments with the single-pass
variance max(E[x^2] - E[x]^2, 0), a different numeric from K1's two-pass
one. K9 is one ctypes call that enqueues two launches and nothing between
them: the moments launch sums slices of each sample's rows and its last
block per sample combines the slices' partials into the (B, 2, C) mean and
inverse std on the card (the JAX package runs that combine as small XLA ops
between its two kernels); the apply launch normalises. Its grid follows
`temporal_plan`, sized from the SM count. Its plain twin
(`group_norm_temporal_plain`) has the JAX numerics: per-row f32 moments, the
one-hot group combine, the clamp. Its gradient recomputes the exact
two-pass `group_norm_plain` (the JAX `_gn_bwd`).

K10 replaces the Pallas kernel `_gn_big_kernel` (entry
`group_norm_fused_big`): the same function over (B, T, ..., C), which the
TPU computed in one call for samples too large for VMEM. On the card it is
K1 on the (B, T*HW, C) view, by K1's plan (one cluster launch where a
sample fits 8 blocks, else statistics + apply): K1's exact two-pass variance
where the JAX kernel takes the single-pass one, so its plain twin is K1's,
`group_norm_plain` (within 1e-5 of the JAX kernel in f32 on the CPU tests'
inputs).

The model takes K9 only behind `CAMC2V_GN_TEMPORAL=1` (5-D temporal norms)
and `CAMC2V_GN_BIG4D=1` (large 4-D maps viewed as (N, s, H/s*W, C)), at the
sites the JAX predicates below pick (`nn/layers.py::GroupNorm32`). K10 has
no model caller (as in the JAX package); `chip_smoke.py` reaches it through
its entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.ops import _build
from camc2v_tpu_torch.ops._gemm import sm_count


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


def group_norm_fused(x, scale, bias, *, num_groups: int = 32, eps: float = 1e-5, silu: bool = False,
                     kernel: bool = True):
    """GroupNorm over (N, ..., C): stats per (sample, group) over all middle
    dims, through `ops.recompute_grad`. CPU tensors take the plain twin;
    CUDA tensors launch K1 unless `kernel` is False (the seam's plain route)."""
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    twin = functools.partial(group_norm_plain, **kw)
    run = functools.partial(_launch, **kw) if ops.on_card(x, "group_norm_fused") and kernel else twin
    return ops.recompute_grad(run, twin, x, scale, bias)


def _launch(x, scale, bias, *, num_groups: int, eps: float, silu: bool, counter: str = "groupnorm"):
    """K1 on the card: the wrapper's checks, the plan, one ctypes call of
    one launch (cluster path) or two (statistics, apply); counted under
    `ops.LAUNCHES[counter]` (K10 runs it as "groupnorm_big")."""
    if not x.is_cuda:
        raise ValueError(f"group_norm_fused: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"group_norm_fused: dtype {x.dtype} (needs bfloat16 or float32)")
    if not x.is_contiguous() or x.data_ptr() % K9_PIECE_BYTES:
        raise ValueError("group_norm_fused: x must be contiguous and start on a 16-byte boundary")
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"group_norm_fused: C={c} must be divisible by groups={num_groups}")
    if scale.dtype != torch.float32 or not scale.is_contiguous():
        scale = scale.float().contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    if scale.shape != (c,) or bias.shape != (c,) or scale.device != x.device or bias.device != x.device:
        raise ValueError("group_norm_fused: scale/bias must be (C,) on x's device")
    rows = x.numel() // (n * c)
    plan = norm_plan(n, rows, c, x.element_size(), num_groups, sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    y = torch.empty_like(x)
    ws = stats = counters = 0
    if not plan.cluster:
        parts = n * plan.slices * (3 * num_groups + 1)
        scratch, count = _stream_scratch(x.device, stream, n, parts + n * 2 * c)
        ws, stats, counters = scratch.data_ptr(), scratch.data_ptr() + 4 * parts, count.data_ptr()
    apply = plan.apply or TemporalPlan(0, 0, 0)
    fn = _build.function("groupnorm", "gn_forward", _K1_ARGS)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws, stats, counters, n, rows, c,
             num_groups, int(plan.cluster), plan.slices, plan.rgroups, apply.splits, apply.rgroups, float(eps),
             int(silu), int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "group_norm_fused")
    ops.LAUNCHES[counter] += 1
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
    """GroupNorm of (B, T, ..., C) with statistics per (B, group) over
    (T, ...), the function of `group_norm_fused_temporal` (K10): on the card
    K1 over the (B, T*HW, C) view by K1's plan, on the CPU K1's twin."""
    if x.dim() < 3:
        raise ValueError(f"group_norm_fused_big: x {tuple(x.shape)} needs (B, T, ..., C)")
    kw = dict(num_groups=num_groups, eps=eps, silu=silu)
    twin = functools.partial(group_norm_plain, **kw)
    run = functools.partial(_launch, counter="groupnorm_big", **kw) if ops.on_card(x, "group_norm_fused_big") \
        else twin
    return ops.recompute_grad(run, twin, x.contiguous(), scale, bias)


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


# K9's plan: the kernels' partition of each sample's rows (the C entry
# computes a slice's rows with the same formula as `slice_rows`)
K9_PIECE_BYTES = 16   # one thread's load: 8 bf16 or 4 f32 channels
K9_THREADS = 256      # a block's threads, where a row has fewer pieces
K9_MAX_PIECES = 512   # the most pieces a row may have (one thread each)
K9_UNROLL = 4         # loads in flight per thread (csrc K9_UNROLL)
K9_BLOCKS_PER_SM = 2  # blocks per SM the grid is sized for


class TemporalPlan(NamedTuple):
    splits: int   # slices (blocks) per sample
    rgroups: int  # row groups of a block
    pieces: int   # 16-byte pieces of a row (threads per row group)


@functools.lru_cache(maxsize=None)
def temporal_plan(b: int, rows: int, c: int, elem: int, sms: int) -> TemporalPlan:
    """K9's grid for b samples of `rows` rows of c channels of `elem` bytes
    on `sms` SMs: at most K9_BLOCKS_PER_SM blocks per SM over all samples
    (one wave: the apply kernel's registers let two 256-thread blocks share
    an SM), and no more slices than leave each thread K9_UNROLL rows."""
    pieces = c * elem // K9_PIECE_BYTES
    if c * elem % K9_PIECE_BYTES or not 0 < pieces <= K9_MAX_PIECES:
        raise ValueError(f"group_norm_fused_temporal: C={c} must fill whole 16-byte pieces, at most {K9_MAX_PIECES}")
    rgroups = max(1, K9_THREADS // pieces)
    want = K9_BLOCKS_PER_SM * sms // b
    splits = max(1, min(want, -(-rows // (rgroups * K9_UNROLL))))
    return TemporalPlan(splits, rgroups, pieces)


def slice_rows(rows: int, splits: int, si: int) -> tuple[int, int]:
    """Rows [r0, r1) of slice si of a sample (the kernels' formula)."""
    return rows * si // splits, rows * (si + 1) // splits


# K1's plan: one launch on a cluster where a sample fits one, else two
K1_THREADS = 512              # a block's most threads (csrc/groupnorm.cu THREADS_MAX)
K1_CHUNKS = 8                 # bulk copies (each on its mbarrier) per slice (csrc CHUNKS)
K1_SMEM_MAX = 232448          # a block's shared memory on the H100
K1_STATIC_SMEM = 128          # what the kernels' own shared variables may take of it (csrc STATIC_SMEM)
K1_MAX_CLUSTER = 8            # the portable cluster size
K1_BLOCKS_PER_SM = 2          # the statistics launch's blocks an SM
K1_BLOCK_SMEM = (233472 // K1_BLOCKS_PER_SM - 1024 - K1_STATIC_SMEM)  # an SM's 228 KB, 1 KB reserved a block
K1_MIN_SLICES = 3            # a sample's fewest blocks on the cluster path (its rows spread for small samples)


class NormPlan(NamedTuple):
    cluster: bool   # one launch on clusters of `slices` blocks (else statistics, then apply)
    slices: int     # blocks per sample holding its rows (slice_rows)
    rgroups: int    # row groups of a block
    pieces: int     # 16-byte pieces of a row (threads per row group)
    smem: int       # a block's dynamic shared memory, bytes
    apply: TemporalPlan | None  # the apply launch's grid (two launches only)


def k1_smem(max_rows: int, c: int, elem: int, rgroups: int, groups: int) -> int:
    """A K1 block's dynamic shared memory (csrc/groupnorm.cu `make_params`):
    its slice of at most `max_rows` rows, the row groups' per-channel sums,
    the slice's statistics (3 G + 1 floats) and the cluster's K1_MAX_CLUSTER
    of them, the (2, G) group mean and inverse std, and 8 bytes per chunk's
    barrier."""
    gstat_end = max_rows * c * elem + rgroups * c * 4 + ((1 + K1_MAX_CLUSTER) * (3 * groups + 1) + 2 * groups) * 4
    return -(-gstat_end // 8) * 8 + 8 * K1_CHUNKS


@functools.lru_cache(maxsize=None)
def norm_plan(n: int, rows: int, c: int, elem: int, groups: int, sms: int) -> NormPlan:
    """K1's launch for n samples of `rows` rows of c channels of `elem`
    bytes in `groups` groups on `sms` SMs. A sample's slices (and so the
    order its statistics merge in) follow from its own shape, never from
    n: a sample gives the same bits alone and inside any batch. One launch
    where a cluster of at most K1_MAX_CLUSTER blocks holds a sample: the
    fewest blocks (at least K1_MIN_SLICES, at most the rows) whose shared
    memory lets two share an SM, else the fewest that fit one an SM; a
    batch of more clusters than the card holds runs in waves. Else the
    statistics launch on as few slices as K1_BLOCK_SMEM allows, and at
    least half the SMs' worth, then K9's apply (whose grid alone follows
    n: it does not touch the statistics)."""
    row = c * elem
    pieces = row // K9_PIECE_BYTES
    if row % K9_PIECE_BYTES or not 0 < pieces <= K1_THREADS or c % groups:
        raise ValueError(f"group_norm_fused: C={c} must fill whole 16-byte pieces, at most {K1_THREADS}, "
                         f"in {groups} groups")
    if groups > 32:
        raise ValueError(f"group_norm_fused: {groups} groups (at most 32: a lane each in the merge)")
    rgroups = K1_THREADS // pieces

    def smem(slices):
        return k1_smem(-(-rows // slices), c, elem, rgroups, groups)

    sizes = range(min(K1_MIN_SLICES, rows), min(K1_MAX_CLUSTER, rows) + 1)
    fits = [k for k in sizes if smem(k) + K1_STATIC_SMEM <= K1_SMEM_MAX]
    if fits:
        slices = next((k for k in fits if smem(k) <= K1_BLOCK_SMEM), fits[0])
    else:
        kmin = -(-rows // ((K1_BLOCK_SMEM - k1_smem(0, c, elem, rgroups, groups)) // row))
        slices = min(rows, max(kmin, -(-sms // 2)))
    if rows * slices >= 2 ** 31:
        raise ValueError(f"group_norm_fused: {rows} rows exceed what a launch takes")
    return NormPlan(bool(fits), slices, rgroups, pieces, smem(slices),
                    None if fits else temporal_plan(n, rows, c, elem, sms))


_scratch: dict = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_TEMPORAL_ARGS = [_P] * 7 + [_I, ctypes.c_longlong] + [_I] * 4 + [_F, _I, _I, _P]
_K1_ARGS = [_P] * 7 + [_I, ctypes.c_longlong] + [_I] * 7 + [_F, _I, _I, _P]


def _stream_scratch(device, stream: int, b: int, floats: int):
    """The stream's scratch of K1's and K9's two-launch paths, kept across
    calls (stream order makes each call's use of it end before the next
    one's begins): f32 workspace and stats, and the samples' arrival
    counters, zeroed once and left zero by every call. Grown when a call
    needs more."""
    key = (device, stream)
    ws, counters = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < floats or counters.numel() < b:
        ws = torch.empty(floats, device=device, dtype=torch.float32)
        counters = torch.zeros(b, device=device, dtype=torch.int32)
        _scratch[key] = ws, counters
    return ws, counters


def _launch_temporal(x, scale, bias, *, num_groups: int, eps: float, silu: bool):
    """K9: one ctypes call, two launches (moments with the combine, apply)."""
    x, scale, bias = _twophase_args(x, scale, bias, num_groups, "group_norm_fused_temporal")
    if x.data_ptr() % K9_PIECE_BYTES:
        raise ValueError("group_norm_fused_temporal: x must start on a 16-byte boundary")
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    plan = temporal_plan(b, rows, c, x.element_size(), sm_count(x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = b * plan.splits * 2 * num_groups
    ws, counters = _stream_scratch(x.device, stream, b, parts + b * 2 * c)
    y = torch.empty_like(x)
    fn = _build.function("groupnorm_twophase", "gn_temporal", _TEMPORAL_ARGS)
    err = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * parts,
             counters.data_ptr(), b, rows, c, num_groups, plan.splits, plan.rgroups, float(eps), int(silu),
             int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "group_norm_fused_temporal")
    ops.LAUNCHES["groupnorm_temporal"] += 1
    return y
