"""Exponential moving average of parameters (`camc2v_tpu/core/ema.py`;
reference lvdm/ema.py `LitEma`): decay warmup `min(decay, (1 + step) /
(10 + step))` driven by the update counter. The port keeps the average as a
dict of tensors beside the model and updates it in place (the JAX version
returns a new pytree)."""

from __future__ import annotations

import torch


@torch.no_grad()
def init_ema(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {name: p.detach().clone() for name, p in params.items()}


@torch.no_grad()
def update_ema(ema_params: dict[str, torch.Tensor], params: dict[str, torch.Tensor], step: int,
               decay: float = 0.9999, use_num_updates: bool = True) -> dict[str, torch.Tensor]:
    """e <- e - (1 - d) * (e - p) for every entry, in place; returns the dict."""
    d = min(decay, (1.0 + step) / (10.0 + step)) if use_num_updates else decay
    for name, e in ema_params.items():
        e.sub_((1.0 - d) * (e - params[name]))
    return ema_params
