"""Kernel seams of the port.

Each op module holds hand-written CUDA kernels (sources in `csrc/`), a
wrapper that launches them for CUDA tensors, and the plain PyTorch twin with
the JAX plain-path numerics that the wrapper uses for CPU tensors.

`route()` is the one rule by which the model's seams choose between a
kernel and its plain twin: a kernel runs for every tensor on the card whose
dtype it takes. K1 takes bf16 and f32; K2-K7 are bf16 kernels, so a model
built in f32 runs them on their plain twins on the card too. A shape that a
kernel cannot take raises in its wrapper, except at the sites each seam's
docstring lists as staying plain. Inside a `plain_twins()` block every seam
runs its plain twin (the counterpart of the JAX package's
`use_pallas_flash(False)` / `use_fused(False)` switches), so one run can hold
the kernel path against the plain path end to end.

Gradients: every wrapper calls its `torch.autograd.Function`, with or
without a gradient (autograd records nothing under `torch.no_grad()`). The
Function runs kernel or twin, as the wrapper chose (`on_card`, or the seam's
plain route), for the forward and makes the same choice for the backward: K2's backward is K5 and
K6's is K7 (or their chunked twins); K1, K3 and K4 differentiate their plain
twin, recomputed from the saved inputs (`recompute_grad`), as the JAX custom
VJPs do. A ctypes launch writes a fresh tensor outside the graph, so kernels
launch only with grad mode off, as inside a Function's forward and backward:
`_build.load`, which every launch calls, raises otherwise.

A forward that records a gradient runs through one dispatcher op,
`torch.ops.camc2v.kernel_forward` (`saved_forward`): a ctypes launch is
invisible to PyTorch's dispatcher, so without the op a selective-checkpoint
policy could not save the kernels' outputs (the UNet's `pallas` remat
policy, `nn/unet3d.py::remat_policy`). The op takes the forward's tensors
and returns its outputs (K2's and K6's with their logsumexp); its fake
implementation is the plain twin. Forwards without a gradient (generation)
launch directly, so the op adds nothing to generation's launch path.

`LAUNCHES` counts, per kernel wrapper, the calls that launched it on the
card (K5 and K7 each launch their dq and dk/dv kernels in one call, K9 its
moments and apply kernels); `reset_launch_counts()` zeroes it.

The reference's opt-in routes read the JAX package's environment switches,
all off by default, at the same decision points (`switch_on`):
`CAMC2V_LN_FUSED` (K8, `nn/layers.py::LayerNormF32`), `CAMC2V_GN_TEMPORAL`
and `CAMC2V_GN_BIG4D` (K9, `nn/layers.py::GroupNorm32`), `CAMC2V_EPI_PRECOMP`
(K6p, `nn/epipolar.py::add_precomputed_penalties`) and `CAMC2V_FUSED_CFG`
(`models/dynamicrafter.py::build_guided_fn`). Like the JAX package, which
ignores the norm switches on its CPU backend, the norm sites follow their
switches only for tensors on the card.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

import torch

LAUNCHES: dict[str, int] = {
    "groupnorm": 0,
    "flash_attention": 0,
    "temporal_attention": 0,
    "geglu_ff": 0,
    "epipolar_flash": 0,
    "flash_bwd": 0,
    "epipolar_bwd": 0,
    "layernorm": 0,
    "groupnorm_temporal": 0,
    "groupnorm_big": 0,
    "epipolar_flash_precomp": 0,
}

_plain_depth = 0


def switch_on(name: str) -> bool:
    """True when the environment switch `name` is "1" (default off)."""
    return os.environ.get(name, "0") == "1"


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_twins():
    """Run every seam on its plain twin, CUDA tensors included (forward and
    backward)."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def route(x: torch.Tensor, dtype=None, *, takes=(torch.bfloat16,)) -> bool:
    """True when a seam launches its kernel for `x`: x lies on the card, no
    `plain_twins()` block is open, and `dtype` (the dtype the kernel would
    see, x's own by default) is one the kernel `takes`."""
    return x.is_cuda and _plain_depth == 0 and (x.dtype if dtype is None else dtype) in takes


def on_card(x: torch.Tensor, what: str) -> bool:
    """A wrapper's rule: its twin for a CPU tensor (False), its kernel for a
    CUDA tensor (True); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.is_cuda


# the forward a `saved_forward` call runs: an op's schema takes tensors, not
# callables, so the callable rides here for the length of the call
_forward_fns = threading.local()


@torch.library.custom_op("camc2v::kernel_forward", mutates_args=())
def _kernel_forward(tensors: list[Optional[torch.Tensor]]) -> list[torch.Tensor]:
    outs = _forward_fns.run(*tensors)
    outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
    inputs = {t.untyped_storage().data_ptr() for t in tensors if t is not None}
    # an op's output may not alias its input (a twin may hand one back)
    return [o.clone() if o.untyped_storage().data_ptr() in inputs else o for o in outs]


@_kernel_forward.register_fake
def _(tensors):
    outs = _forward_fns.twin(*tensors)
    return [outs] if isinstance(outs, torch.Tensor) else list(outs)


def saved_forward(run, twin, *tensors):
    """`run(*tensors)` (a kernel launch, or `twin` on the plain route) as the
    dispatcher op `camc2v::kernel_forward`, whose outputs a selective
    checkpoint can save; the outputs come back as run returns them (a
    tensor, or a tuple)."""
    prev = getattr(_forward_fns, "run", None), getattr(_forward_fns, "twin", None)
    _forward_fns.run, _forward_fns.twin = run, twin
    try:
        outs = torch.ops.camc2v.kernel_forward(list(tensors))
    finally:
        _forward_fns.run, _forward_fns.twin = prev
    return outs[0] if len(outs) == 1 else tuple(outs)


class _Recompute(torch.autograd.Function):
    """forward: `run(*tensors)` (a kernel launch or its plain twin; through
    `saved_forward` when a gradient is recorded); backward: the
    vector-Jacobian product of `twin(*tensors)`, recomputed from the saved
    inputs under `torch.enable_grad()`. No remat policy changes that
    backward: it re-runs the f32 twin whatever the forward saved."""

    @staticmethod
    def forward(ctx, run, twin, *tensors):
        ctx.twin = twin
        ctx.save_for_backward(*tensors)
        if any(ctx.needs_input_grad[2:]):
            return saved_forward(run, twin, *tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, gout):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) if t is not None else None
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.twin(*inputs)
            wrt = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wrt, gout))
        return (None, None, *(next(grads) if n else None for n in needs))


def recompute_grad(run, twin, *tensors):
    """`run(*tensors)` with the gradient of `twin(*tensors)` (the JAX rule
    `vjp(plain)` of the K1, K3 and K4 seams)."""
    return _Recompute.apply(run, twin, *tensors)
