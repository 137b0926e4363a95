"""Weights of the port: the JAX bridge, seeded random init, inference cast.

`load_jax_params(module, flat)` fills a port module from the JAX package's
parameters, given as a flat `{"unet/in_0_res/in_conv/kernel": ndarray}` dict
(flattening the JAX tree is the caller's job; it needs jax). Names map one
to one: `GroupNorm_0` / `LayerNorm_0` path segments drop out, `kernel` and
`scale` become `weight`, Dense kernels (in, out) transpose to (out, in), and
Conv kernels HWIO / DHWIO become OIHW / OIDHW. The load is strict: every
parameter of the module is filled exactly once, every JAX leaf is used or
matched by `skip`, and shapes must agree; anything else raises.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Mapping

import numpy as np
import torch
from torch import nn

from camc2v_tpu_torch.nn.layers import Conv, Dense, GroupNorm32, LayerNormF32

_DROPPED = {"GroupNorm_0", "LayerNorm_0"}


def jax_to_torch_name(jax_key: str) -> str:
    parts = [p for p in jax_key.split("/") if p not in _DROPPED]
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _to_torch_layout(jax_key: str, value: np.ndarray) -> np.ndarray:
    if not jax_key.endswith("/kernel"):
        return value
    if value.ndim == 2:
        return value.T
    if value.ndim == 4:  # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if value.ndim == 5:  # DHWIO -> OIDHW
        return value.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"{jax_key}: kernel of rank {value.ndim}")


def load_jax_params(module: nn.Module, flat: Mapping[str, np.ndarray], *, skip: Iterable[str] = ()) -> None:
    """Strictly copy JAX params into `module` (see the module docstring).

    skip: regular expressions; JAX keys that fully match one are ignored."""
    skip_res = [re.compile(s) for s in skip]
    params = dict(module.named_parameters())
    filled: set[str] = set()
    unused = []
    for key, value in flat.items():
        if any(r.fullmatch(key) for r in skip_res):
            continue
        name = jax_to_torch_name(key)
        if name not in params:
            unused.append(key)
            continue
        if name in filled:
            raise ValueError(f"load_jax_params: {name} filled twice (second source {key})")
        arr = np.array(_to_torch_layout(key, np.asarray(value)), order="C", copy=True)
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_params: {key} {arr.shape} -> {name} {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(arr).to(p.dtype))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if unused or missing:
        raise ValueError(
            f"load_jax_params: {len(unused)} JAX leaves unused {unused[:8]}, "
            f"{len(missing)} port params not filled {missing[:8]}"
        )


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for running without a checkpoint.

    Dense/Conv weights ~ N(0, 1/fan_in) (lecun normal, untruncated)
    and zero biases; norms at identity; embeddings N(0, 0.02), positional
    N(0, 0.01), resampler latents N(0, dim^-1/2). Unlike a fresh JAX init
    no projection is zero, so every branch is live (what a trained
    checkpoint looks like, and what `perturb_zero_kernels` does in tests)."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and p.dim() >= 2:
            fan_in = math.prod(p.shape[1:])
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
        elif leaf in ("token_embedding", "class_embedding"):
            p.normal_(0.0, 0.02, generator=generator)
        elif leaf == "positional_embedding":
            p.normal_(0.0, 0.01, generator=generator)
        elif leaf == "latents":
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
    for m in module.modules():
        if isinstance(m, (Dense, Conv)) and m.bias is not None:
            m.bias.zero_()
        elif isinstance(m, (GroupNorm32, LayerNormF32)):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def cast_for_inference(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Store every Dense/Conv weight and bias in the compute dtype (the
    numbers the JAX cast-at-use gives); norm scales and biases stay f32."""
    for m in module.modules():
        if isinstance(m, (Dense, Conv)):
            m.weight.data = m.weight.data.to(dtype)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(dtype)
    return module
