"""The sampling loops (`camc2v_tpu/models/sampler.py`): DDIM with the latent
surgery, the ancestral DDPM loop, DPM-Solver++(2M), and img2img's
`ddim_decode` / `ddim_stochastic_encode`.

Python loops over the timestep tables. Every per-step coefficient is a
float32 value read from the host tables before it is used, and the step
timestep is a tensor filled on the device, so a loop never waits for the
device (no `.item()`, no `.cpu()`). Guidance lives in the model-provided
`model_out_fn(x, t, step)` closure (`DynamiCrafter.build_guided_fn`): t is
the step's timestep as a (B,) device tensor and `step` the same as a host
int, which is how camera CFG's scheduler and `cfg_interval` read the
timestep without a sync.

Random draws come from the caller's `generator`, or, in their place, from
`step_noise`: one record per step, in loop order, of that step's
standard-normal draws by name, each of the loop's own shape:
  "noise"    the eta noise (DDIM, `ddim_decode`) or the ancestral noise;
  "overlap"  the re-noising of the overlap frames and of noise shaping;
  "blend"    the noise of the blend's `q_sample`;
  "keep"     (bool) the eta-noise dropout's keep mask.
A bare tensor is the record {"noise": tensor}. The JAX key chain splits each
step's key into (carry, noise, overlap, blend) in `ddim_sample`, (carry,
noise, blend) in `p_sample_loop` and (carry, draw) in `dpmpp_2m_sample`
(overlap) and `ddim_decode` (noise); the dropout mask's key is split from
the carry after those, and the carry continues from it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from camc2v_tpu_torch.core.schedules import (DDIMSchedule, DiffusionSchedule, predict_eps_from_z_and_v,
                                             predict_start_from_noise, predict_start_from_z_and_v, q_posterior)

ModelOutFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
StepDraws = Union[torch.Tensor, Mapping[str, torch.Tensor]]

f32 = np.float32


@dataclasses.dataclass(frozen=True)
class SamplerOptions:
    """Static sampling options (the JAX `SamplerOptions`)."""

    temperature: float = 1.0
    # dropout on the eta noise (reference ddim.py:341-343), inverted scaling
    noise_dropout: float = 0.0
    parameterization: str = "eps"
    paste_cond_frame: bool = False
    num_overlap: int = 0  # paste_overlap_frames when > 0
    # scene-constrained noise shaping (reference samplers/ddim.py:190-199):
    # while the step's timestep >= noise_shaping_min_t, scene_mask regions
    # are re-noised from the clean scene latents
    noise_shaping: bool = False
    noise_shaping_min_t: int = 600
    # the mask/x0 blend (reference samplers/ddim.py:173-180) re-imposes x0
    # noised to the step's timestep, or clean with clean_cond
    clean_cond: bool = False


class _Draws:
    """One step's draws: from the step's record, or from the generator."""

    def __init__(self, step_noise: Optional[Sequence[StepDraws]], steps: int, generator, like: torch.Tensor):
        if step_noise is not None and len(step_noise) != steps:
            raise ValueError(f"step_noise has {len(step_noise)} entries for {steps} steps")
        self.records, self.generator, self.like = step_noise, generator, like
        self.idx = 0

    def at(self, idx: int) -> "_Draws":
        self.idx = idx
        return self

    def normal(self, name: str, shape) -> torch.Tensor:
        if self.records is not None:
            rec = self.records[self.idx]
            return rec if isinstance(rec, torch.Tensor) and name == "noise" else rec[name]
        return torch.randn(tuple(shape), generator=self.generator, device=self.like.device, dtype=self.like.dtype)

    def keep(self, p_keep: float, shape) -> torch.Tensor:
        if self.records is not None:
            return self.records[self.idx]["keep"]
        return torch.rand(tuple(shape), generator=self.generator, device=self.like.device) < p_keep


def _timestep(b: int, step: int, device) -> torch.Tensor:
    return torch.full((b,), int(step), dtype=torch.int32, device=device)


def _q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, step: int, noise: torch.Tensor) -> torch.Tensor:
    """`q_sample` at one timestep known on the host."""
    return float(schedule.sqrt_alphas_cumprod[step]) * x0 + float(schedule.sqrt_one_minus_alphas_cumprod[step]) * noise


def _eps_x0(ddim: DDIMSchedule, i: int, schedule: Optional[DiffusionSchedule], step: int, x, model_output,
            opt: SamplerOptions):
    """(eps, x0-hat) of the model output at DDIM table position i (timestep
    `step`): from `v` through the DDPM tables, from `eps` through the DDIM
    ones."""
    if opt.parameterization == "v":
        return (predict_eps_from_z_and_v(schedule, x, step, model_output),
                predict_start_from_z_and_v(schedule, x, step, model_output))
    return model_output, (x - float(ddim.sqrt_one_minus_alphas[i]) * model_output) / float(np.sqrt(ddim.alphas[i]))


def _dropout(noise: torch.Tensor, opt: SamplerOptions, draws: _Draws) -> torch.Tensor:
    if opt.noise_dropout <= 0:
        return noise
    keep = draws.keep(1.0 - opt.noise_dropout, noise.shape)
    return noise * keep / (1.0 - opt.noise_dropout)


def _selectors(x_T: torch.Tensor, opt: SamplerOptions, cond_frame_index: Optional[torch.Tensor]):
    """(overlap frames, conditioning frame) as broadcastable bool masks."""
    tdim, dev = x_T.shape[1], x_T.device
    overlap_sel = (torch.arange(tdim, device=dev) < opt.num_overlap)[None, :, None, None, None]
    cond_sel = None
    if opt.paste_cond_frame:
        idx = cond_frame_index.to(dev).long()
        cond_sel = (torch.arange(tdim, device=dev)[None, :] == idx[:, None])[:, :, None, None, None]
    return overlap_sel, cond_sel


def _final_surgery(x, opt, origin_z0, overlap_sel, cond_sel):
    """The reference's last latent surgery (ddim.py:226-238)."""
    if opt.num_overlap > 0:
        x = torch.where(overlap_sel, origin_z0, x)
    if opt.paste_cond_frame:
        x = torch.where(cond_sel, origin_z0, x)
    return x


def _ddim_update(ddim: DDIMSchedule, i: int, x, pred_x0, e_t, opt: SamplerOptions, draws: _Draws):
    """x_{prev} of the DDIM step at table position i."""
    a_prev, sigma_t = ddim.alphas_prev[i], ddim.sigmas[i]
    dir_coef = np.sqrt(np.maximum(f32(1.0) - a_prev - sigma_t * sigma_t, f32(0.0)))
    noise = float(sigma_t) * draws.normal("noise", x.shape)
    if opt.temperature != 1.0:
        noise = noise * opt.temperature
    noise = _dropout(noise, opt, draws)
    return float(np.sqrt(a_prev)) * pred_x0 + float(dir_coef) * e_t + noise


def ddim_sample(ddim: DDIMSchedule, x_T: torch.Tensor, model_out_fn: ModelOutFn, *,
                options: SamplerOptions = SamplerOptions(), schedule: Optional[DiffusionSchedule] = None,
                origin_z0: Optional[torch.Tensor] = None, cond_frame_index: Optional[torch.Tensor] = None,
                scene_frames: Optional[torch.Tensor] = None, scene_mask: Optional[torch.Tensor] = None,
                blend_mask: Optional[torch.Tensor] = None, blend_x0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
    """The DDIM trajectory from x_T (B, T, h, w, C) (reference
    samplers/ddim.py:133-346), with the options of `SamplerOptions`.

    schedule: the DDPM tables, needed for `v`, overlap, noise shaping and
    the noised blend. origin_z0: the clean latents of the paste / overlap
    surgery; cond_frame_index (B,): the frame pasted. blend_mask / blend_x0:
    the per-pixel blend, any shape broadcastable to x. Returns the final
    latents."""
    opt = options
    steps, b = ddim.num_steps, x_T.shape[0]
    if opt.num_overlap > 0 or opt.paste_cond_frame:
        assert origin_z0 is not None, "latent surgery needs origin_z0"
    if blend_mask is not None:
        assert blend_x0 is not None, "blend_mask needs blend_x0 (reference ddim.py:175)"
    if opt.num_overlap > 0 or opt.parameterization == "v" or opt.noise_shaping or (
            blend_mask is not None and not opt.clean_cond):
        assert schedule is not None, "this sampler configuration needs the full DiffusionSchedule"
    if opt.noise_shaping:
        assert scene_mask is not None, "noise_shaping needs scene_mask"
        assert scene_frames is not None or origin_z0 is not None, "noise_shaping needs scene_frames or origin_z0"
    draws = _Draws(step_noise, steps, generator, x_T)
    overlap_sel, cond_sel = _selectors(x_T, opt, cond_frame_index)
    x = x_T
    for idx in range(steps):
        i = steps - 1 - idx  # descending through the table
        step = int(ddim.timesteps[i])
        t = _timestep(b, step, x.device)
        draws.at(idx)
        if blend_mask is not None:
            img_orig = blend_x0 if opt.clean_cond else _q_sample(schedule, blend_x0, step,
                                                                  draws.normal("blend", blend_x0.shape))
            x = img_orig * blend_mask + (1.0 - blend_mask) * x
        if opt.num_overlap > 0 or opt.noise_shaping:
            renoise = draws.normal("overlap", x.shape)  # one draw serves both, as the JAX key does
        if opt.num_overlap > 0:
            x = torch.where(overlap_sel, _q_sample(schedule, origin_z0, step, renoise), x)
        if opt.noise_shaping:
            src = scene_frames if scene_frames is not None else origin_z0
            m = scene_mask * float(step >= opt.noise_shaping_min_t)
            x = _q_sample(schedule, src, step, renoise) * m + (1.0 - m) * x
        model_output = model_out_fn(x, t, step)
        e_t, pred_x0 = _eps_x0(ddim, i, schedule, step, x, model_output, opt)
        if ddim.scale_arr is not None:
            # dynamic rescale (reference ddim.py:316-320): undo one step of the train-time ramp
            pred_x0 = pred_x0 * float(ddim.scale_arr_prev[i] / ddim.scale_arr[i])
        if opt.paste_cond_frame:
            pred_x0 = torch.where(cond_sel, origin_z0, pred_x0)
        if opt.num_overlap > 0:
            pred_x0 = torch.where(overlap_sel, origin_z0, pred_x0)
        x = _ddim_update(ddim, i, x, pred_x0, e_t, opt, draws)
    return _final_surgery(x, opt, origin_z0, overlap_sel, cond_sel)


def p_sample_loop(schedule: DiffusionSchedule, x_T: torch.Tensor, model_out_fn: ModelOutFn, *,
                  options: SamplerOptions = SamplerOptions(), clip_denoised: bool = False,
                  t_start: Optional[int] = None, blend_mask: Optional[torch.Tensor] = None,
                  blend_x0: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
                  step_noise: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
    """Ancestral DDPM sampling (reference ddpm3d.py:277-305, :905-972), from
    timestep t_start - 1 (default: the whole table) down to 0: x0-hat from
    the `eps` or `x0` output (clamped to [-1, 1] with clip_denoised), the
    posterior mean plus exp(0.5 log sigma^2) noise (none at t = 0), then the
    blend re-imposed, noised to the step's t. `v` raises, as in the
    reference's p_mean_variance."""
    opt = options
    if opt.parameterization not in ("eps", "x0"):
        raise NotImplementedError(f"ancestral sampling supports eps/x0 only (reference p_mean_variance parity), "
                                  f"got {opt.parameterization!r}")
    n = schedule.num_timesteps if t_start is None else min(t_start, schedule.num_timesteps)
    if blend_mask is not None:
        assert blend_x0 is not None, "blend_mask needs blend_x0 (reference ddpm3d.py:949-951)"
    b = x_T.shape[0]
    draws = _Draws(step_noise, n, generator, x_T)
    x = x_T
    for idx in range(n):
        i = n - 1 - idx
        t = _timestep(b, i, x.device)
        draws.at(idx)
        model_output = model_out_fn(x, t, i)
        if opt.parameterization == "x0":
            x_recon = model_output
        else:
            x_recon = predict_start_from_noise(schedule, x, i, model_output)
        if clip_denoised:
            x_recon = x_recon.clamp(-1.0, 1.0)
        mean, log_var = q_posterior(schedule, x_recon, x, i)
        noise = draws.normal("noise", x.shape)
        if opt.temperature != 1.0:
            noise = noise * opt.temperature
        noise = _dropout(noise, opt, draws)
        if i != 0:  # no noise at the final step
            x = mean + float(np.exp(f32(0.5) * log_var)) * noise
        else:
            x = mean
        if blend_mask is not None:
            img_orig = _q_sample(schedule, blend_x0, i, draws.normal("blend", blend_x0.shape))
            x = img_orig * blend_mask + (1.0 - blend_mask) * x
    return x


def dpmpp_2m_sample(ddim: DDIMSchedule, x_T: torch.Tensor, model_out_fn: ModelOutFn, *,
                    options: SamplerOptions = SamplerOptions(), schedule: Optional[DiffusionSchedule] = None,
                    origin_z0: Optional[torch.Tensor] = None, cond_frame_index: Optional[torch.Tensor] = None,
                    lower_order_final: bool = True, generator: Optional[torch.Generator] = None,
                    step_noise: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
    """DPM-Solver++(2M) over the DDIM timestep table from x_T (B, T, h, w, C)
    (the JAX `dpmpp_2m_sample`, Lu et al. 2022, arXiv:2211.01095). With
    lambda = log(alpha / sigma), h_i = lambda_next - lambda_cur and
    r_i = h_{i-1} / h_i:

        D_i    = (1 + 1/(2 r_i)) x0_i - 1/(2 r_i) x0_{i-1}
        x_next = (sigma_next / sigma_cur) x - alpha_next expm1(-h_i) D_i

    The first step, and with lower_order_final for tables shorter than 15
    steps the last one, are first order (D_i = x0_i). Deterministic but for
    the overlap frames' re-noising; the latent surgery, `v` and dynamic
    rescale as in `ddim_sample`. The coefficient tables are float32,
    computed once before the loop as the JAX package computes them."""
    opt = options
    steps, b = ddim.num_steps, x_T.shape[0]
    if opt.num_overlap > 0 or opt.paste_cond_frame:
        assert origin_z0 is not None, "latent surgery needs origin_z0"
    if opt.num_overlap > 0 or opt.parameterization == "v":
        assert schedule is not None, "this sampler configuration needs the full DiffusionSchedule"
    abar_c = np.clip(ddim.alphas, f32(1e-8), f32(1.0 - 1e-8)).astype(f32)
    abar_p = np.clip(ddim.alphas_prev, f32(1e-8), f32(1.0 - 1e-8)).astype(f32)
    lam_c = f32(0.5) * (np.log(abar_c) - np.log1p(-abar_c))
    lam_p = f32(0.5) * (np.log(abar_p) - np.log1p(-abar_p))
    h = (lam_p - lam_c).astype(f32)
    # the loop visits i = S-1, ..., 0; the step before i is i+1
    h_prev = np.concatenate([h[1:], np.ones_like(h[-1:])])
    g = np.where(np.arange(steps) < steps - 1, h / (f32(2.0) * h_prev), f32(0.0)).astype(f32)  # 1/(2 r_i)
    if lower_order_final and steps < 15:
        g[0] = 0.0
    A = np.sqrt((f32(1.0) - abar_p) / (f32(1.0) - abar_c)).astype(f32)  # sigma_next / sigma_cur
    B = (-np.sqrt(abar_p) * np.expm1(-h)).astype(f32)  # alpha_next (1 - e^-h)
    draws = _Draws(step_noise, steps, generator, x_T)
    overlap_sel, cond_sel = _selectors(x_T, opt, cond_frame_index)
    x, x0_prev = x_T, torch.zeros_like(x_T)
    for idx in range(steps):
        i = steps - 1 - idx
        step = int(ddim.timesteps[i])
        t = _timestep(b, step, x.device)
        draws.at(idx)
        if opt.num_overlap > 0:
            x = torch.where(overlap_sel, _q_sample(schedule, origin_z0, step, draws.normal("overlap", x.shape)), x)
        model_output = model_out_fn(x, t, step)
        pred_x0 = _eps_x0(ddim, i, schedule, step, x, model_output, opt)[1]
        if ddim.scale_arr is not None:
            pred_x0 = pred_x0 * float(ddim.scale_arr_prev[i] / ddim.scale_arr[i])
        if opt.paste_cond_frame:
            pred_x0 = torch.where(cond_sel, origin_z0, pred_x0)
        if opt.num_overlap > 0:
            pred_x0 = torch.where(overlap_sel, origin_z0, pred_x0)
        d = float(f32(1.0) + g[i]) * pred_x0 - float(g[i]) * x0_prev
        x = float(A[i]) * x + float(B[i]) * d
        x0_prev = pred_x0
    return _final_surgery(x, opt, origin_z0, overlap_sel, cond_sel)


def ddim_decode(ddim: DDIMSchedule, x_latent: torch.Tensor, model_out_fn: ModelOutFn, t_start: int, *,
                options: SamplerOptions = SamplerOptions(), schedule: Optional[DiffusionSchedule] = None,
                generator: Optional[torch.Generator] = None,
                step_noise: Optional[Sequence[StepDraws]] = None) -> torch.Tensor:
    """Denoise from DDIM table position t_start down (img2img; reference
    ddim.py:348-368): t_start DDIM steps, no latent surgery."""
    opt = dataclasses.replace(options, noise_dropout=0.0)  # the reference decode drops no noise
    b = x_latent.shape[0]
    draws = _Draws(step_noise, t_start, generator, x_latent)
    x = x_latent
    for idx in range(t_start):
        i = t_start - 1 - idx
        step = int(ddim.timesteps[i])
        t = _timestep(b, step, x.device)
        draws.at(idx)
        model_output = model_out_fn(x, t, step)
        e_t, pred_x0 = _eps_x0(ddim, i, schedule, step, x, model_output, opt)
        x = _ddim_update(ddim, i, x, pred_x0, e_t, opt, draws)
    return x


def ddim_stochastic_encode(ddim: DDIMSchedule, x0: torch.Tensor, t_index: Union[int, torch.Tensor],
                           noise: torch.Tensor) -> torch.Tensor:
    """x0 noised to DDIM table position t_index (an int, or (B,) positions;
    reference ddim.py:370-384)."""
    if isinstance(t_index, int):
        return float(np.sqrt(ddim.alphas[t_index])) * x0 + float(ddim.sqrt_one_minus_alphas[t_index]) * noise
    shape = (-1,) + (1,) * (x0.dim() - 1)
    idx = t_index.to(x0.device).long()
    a = torch.sqrt(torch.as_tensor(ddim.alphas, device=x0.device)[idx]).reshape(shape)
    om = torch.as_tensor(ddim.sqrt_one_minus_alphas, device=x0.device)[idx].reshape(shape)
    return a * x0 + om * noise
