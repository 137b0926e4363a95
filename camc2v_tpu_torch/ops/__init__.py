"""Kernel seams of the port.

Each op module holds one hand-written CUDA kernel (sources in `csrc/`), a
wrapper that launches it for CUDA tensors, and the plain PyTorch twin with
the JAX plain-path numerics that the wrapper uses for CPU tensors.

`route()` is the one rule by which the model's seams choose between a
kernel and its plain twin: a kernel runs for every tensor on the card whose
dtype it takes. K1 takes bf16 and f32; K2-K4 are bf16 kernels, so a model
built in f32 runs them on their plain twins on the card too. A shape that a
kernel cannot take raises in its wrapper, except at the sites each seam's
docstring lists as staying plain. Inside a `plain_twins()` block every seam
runs its plain twin (the counterpart of the JAX package's
`use_pallas_flash(False)` / `use_fused(False)` switches), so one run can hold
the kernel path against the plain path end to end.

`LAUNCHES` counts, per kernel, the wrapper calls that launched it on the
card; `reset_launch_counts()` zeroes it.
"""

from __future__ import annotations

import contextlib

import torch

LAUNCHES: dict[str, int] = {
    "groupnorm": 0,
    "flash_attention": 0,
    "temporal_attention": 0,
    "geglu_ff": 0,
}

_plain_depth = 0


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@contextlib.contextmanager
def plain_twins():
    """Run every seam on its plain twin, CUDA tensors included."""
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
