"""Latent distributions over VAE moments (`camc2v_tpu/core/distributions.py`):
the encoder returns `moments` = concat(mean, logvar) on the channel axis."""

from __future__ import annotations

from typing import Optional

import torch


def split_moments(moments: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, logvar) with logvar clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def sample(moments: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    mean, logvar = split_moments(moments)
    noise = torch.randn(mean.shape, generator=generator, device=mean.device, dtype=mean.dtype)
    return mean + torch.exp(0.5 * logvar) * noise


def mode(moments: torch.Tensor) -> torch.Tensor:
    return split_moments(moments)[0]
