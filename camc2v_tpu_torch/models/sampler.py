"""DDIM sampler (`camc2v_tpu/models/sampler.py::ddim_sample`).

A Python loop over the DDIM steps. Every per-step coefficient is a float32
value computed on the host before the loop, and the step timestep is a
tensor filled on the device, so the loop never waits for the device (no
`.item()`, no `.cpu()`). Guidance lives in the model-provided
`model_out_fn` closure (`DynamiCrafter.build_guided_fn`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from camc2v_tpu_torch.core.schedules import DDIMSchedule

ModelOutFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def ddim_sample(ddim: DDIMSchedule, x_T: torch.Tensor, model_out_fn: ModelOutFn, *,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Run the DDIM trajectory from x_T (B, T, h, w, C), eps parameterization.

    step_noise: optional per-step standard-normal tensors, in loop order, in
    place of draws from `generator` (lets a test feed the JAX key chain's
    noise). Returns the final latents.
    """
    f32 = np.float32
    steps = ddim.num_steps
    if step_noise is not None and len(step_noise) != steps:
        raise ValueError(f"step_noise has {len(step_noise)} entries for {steps} steps")
    b = x_T.shape[0]
    x = x_T
    for idx in range(steps):
        i = steps - 1 - idx  # descending through the table
        t = torch.full((b,), int(ddim.timesteps[i]), dtype=torch.int32, device=x.device)
        e_t = model_out_fn(x, t)
        pred_x0 = (x - float(ddim.sqrt_one_minus_alphas[i]) * e_t) / float(np.sqrt(ddim.alphas[i]))
        a_prev, sigma_t = ddim.alphas_prev[i], ddim.sigmas[i]
        dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma_t * sigma_t, f32(0.0)))
        if step_noise is not None:
            z = step_noise[idx]
        else:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t + float(sigma_t) * z
    return x
