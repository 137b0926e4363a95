"""Weights of the port: the JAX bridges, seeded random init, inference cast.

`load_jax_params(module, flat)` fills a port module from the JAX package's
parameters, given as a flat `{"unet/in_0_res/in_conv/kernel": ndarray}` dict
(flattening the JAX tree is the caller's job; it needs jax). Names map one
to one: `GroupNorm_0` / `LayerNorm_0` path segments drop out, `kernel` and
`scale` become `weight`, Dense kernels (in, out) transpose to (out, in), and
Conv kernels HWIO / DHWIO become OIHW / OIDHW. The camera modules carry the
JAX names too (`.../pluker_projection`, `.../epipolar/epipolar_attn/
{to_q,to_k,to_v,to_out,register_tokens}`, `pose_encoder/level{i}_{res,attn}{j}`,
`adaptor/{latents,proj_in,attn_i,ff_i,temb_fc1,temb_fc2,proj_out,norm_out}`,
and `zero_conv`, a 3x3x3 DHWIO kernel). The load is strict: every
parameter of the module is filled exactly once, every JAX leaf is used or
matched by `skip`, and shapes must agree; anything else raises.

`load_i3d_variables(model, variables)` fills the FVD's I3D
(`eval/fvd.py::InceptionI3D`) from the JAX variables dict, nested dicts of
numpy arrays as `FVDScorer` reads them from a converted `.npz`:
`params/<path>/Conv_0/{kernel,bias}` -> `<path>.conv.{weight,bias}` (DHWIO ->
OIDHW), `params/<path>/BatchNorm_0/{scale,bias}` -> `<path>.bn.{weight,bias}`,
`batch_stats/<path>/BatchNorm_0/{mean,var}` -> `<path>.bn.running_{mean,var}`.
It is as strict, over the parameters and the BatchNorm buffers alike (a
running statistic left at its init would pass unseen otherwise).
`i3d_variables(model)` is its inverse.
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


_I3D_LEAVES = {("params", "Conv_0", "kernel"): "conv.weight", ("params", "Conv_0", "bias"): "conv.bias",
               ("params", "BatchNorm_0", "scale"): "bn.weight", ("params", "BatchNorm_0", "bias"): "bn.bias",
               ("batch_stats", "BatchNorm_0", "mean"): "bn.running_mean",
               ("batch_stats", "BatchNorm_0", "var"): "bn.running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _i3d_targets(model: nn.Module) -> dict:
    targets = dict(model.named_parameters())
    targets.update({n: b for n, b in model.named_buffers() if n.endswith((".running_mean", ".running_var"))})
    return targets


def load_i3d_variables(model: nn.Module, variables: Mapping) -> None:
    """Strictly copy JAX I3D variables into `model` (see the module docstring)."""
    targets = _i3d_targets(model)
    filled: set[str] = set()
    unused = []
    for path, value in _flatten(variables).items():
        leaf = _I3D_LEAVES.get((path[0], path[-2], path[-1]))
        if leaf is None:
            unused.append("/".join(path))
            continue
        name = ".".join(path[1:-2] + (leaf,))
        if name not in targets:
            unused.append("/".join(path))
            continue
        if name in filled:
            raise ValueError(f"load_i3d_variables: {name} filled twice")
        arr = value.transpose(4, 3, 0, 1, 2) if path[-1] == "kernel" else value
        t = targets[name]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"load_i3d_variables: {'/'.join(path)} {arr.shape} -> {name} {tuple(t.shape)}")
        with torch.no_grad():
            t.copy_(torch.from_numpy(np.array(arr, order="C", copy=True)).to(t.dtype))
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if unused or missing:
        raise ValueError(
            f"load_i3d_variables: {len(unused)} JAX leaves unused {unused[:8]}, "
            f"{len(missing)} port tensors not filled {missing[:8]}"
        )


def i3d_variables(model: nn.Module) -> dict:
    """The JAX variables dict of `model` (the inverse of `load_i3d_variables`)."""
    by_leaf = {v: k for k, v in _I3D_LEAVES.items()}
    out: dict = {}
    for name, t in _i3d_targets(model).items():
        parts = name.split(".")
        collection, module, leaf = by_leaf[".".join(parts[-2:])]
        value = t.detach().cpu().numpy()
        if leaf == "kernel":
            value = value.transpose(2, 3, 4, 1, 0)
        node = out.setdefault(collection, {})
        for p in parts[:-2] + [module]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(value)
    return out


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights for running without a checkpoint.

    Dense/Conv weights ~ N(0, 1/fan_in) (lecun normal, untruncated)
    and zero biases; norms at identity; embeddings N(0, 0.02), positional
    N(0, 0.01), resampler and adaptor latents N(0, dim^-1/2), epipolar
    register tokens N(0, 1) (the JAX init). Unlike a fresh JAX init
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
        elif leaf == "register_tokens":
            p.normal_(0.0, 1.0, generator=generator)
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
