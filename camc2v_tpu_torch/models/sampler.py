"""DDIM and DPM-Solver++(2M) samplers (`camc2v_tpu/models/sampler.py::
ddim_sample`, `dpmpp_2m_sample`).

Python loops over the DDIM timestep table. Every per-step coefficient is a
float32 value computed on the host before the loop, and the step timestep is
a tensor filled on the device, so the loop never waits for the device (no
`.item()`, no `.cpu()`). Guidance lives in the model-provided
`model_out_fn` closure (`DynamiCrafter.build_guided_fn`). Neither loop has
the JAX samplers' latent surgery (paste_cond_frame, overlap) or
dynamic-rescale tables: the port's `sample` does not take them.
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


def dpmpp_2m_sample(ddim: DDIMSchedule, x_T: torch.Tensor, model_out_fn: ModelOutFn) -> torch.Tensor:
    """DPM-Solver++(2M) over the DDIM timestep table from x_T (B, T, h, w, C),
    eps parameterization, deterministic (the JAX `dpmpp_2m_sample`, Lu et
    al. 2022, arXiv:2211.01095). With lambda = log(alpha / sigma),
    h_i = lambda_next - lambda_cur and r_i = h_{i-1} / h_i:

        D_i    = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}
        x_next = (sigma_next / sigma_cur) x - alpha_next expm1(-h_i) D_i

    The first step, and for tables shorter than 15 steps the last one, are
    first order (D_i = x0_i). The coefficient tables are float32, computed
    once before the loop as the JAX package computes them."""
    f32 = np.float32
    steps = ddim.num_steps
    abar_c = np.clip(ddim.alphas, f32(1e-8), f32(1.0 - 1e-8)).astype(f32)
    abar_p = np.clip(ddim.alphas_prev, f32(1e-8), f32(1.0 - 1e-8)).astype(f32)
    lam_c = f32(0.5) * (np.log(abar_c) - np.log1p(-abar_c))
    lam_p = f32(0.5) * (np.log(abar_p) - np.log1p(-abar_p))
    h = (lam_p - lam_c).astype(f32)
    # the loop visits i = S-1, ..., 0; the step before i is i+1
    h_prev = np.concatenate([h[1:], np.ones_like(h[-1:])])
    g = np.where(np.arange(steps) < steps - 1, h / (f32(2.0) * h_prev), f32(0.0)).astype(f32)  # 1/(2 r_i)
    if steps < 15:
        g[0] = 0.0
    A = np.sqrt((f32(1.0) - abar_p) / (f32(1.0) - abar_c)).astype(f32)  # sigma_next / sigma_cur
    B = (-np.sqrt(abar_p) * np.expm1(-h)).astype(f32)  # alpha_next (1 - e^-h)
    b = x_T.shape[0]
    x, x0_prev = x_T, torch.zeros_like(x_T)
    for idx in range(steps):
        i = steps - 1 - idx
        t = torch.full((b,), int(ddim.timesteps[i]), dtype=torch.int32, device=x.device)
        e_t = model_out_fn(x, t)
        pred_x0 = (x - float(ddim.sqrt_one_minus_alphas[i]) * e_t) / float(np.sqrt(ddim.alphas[i]))
        d = float(f32(1.0) + g[i]) * pred_x0 - float(g[i]) * x0_prev
        x = float(A[i]) * x + float(B[i]) * d
        x0_prev = pred_x0
    return x
