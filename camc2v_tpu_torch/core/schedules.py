"""Diffusion schedule math (`camc2v_tpu/core/schedules.py`).

Tables are built on the host in float64 and kept as float32 numpy arrays,
exactly as the JAX package freezes them into f32 device arrays, so every
per-step scalar of the sampler is a float32 value known before the loop
starts. The DDPM buffers for the `eps`, `x0` and `v` parameterizations that
the port reads, the DDIM tables with the dynamic-rescale ones,
`timestep_embedding`, `rescale_noise_cfg`, and the training targets
`q_sample` and `get_v`, which gather from a table by a device tensor of
timesteps. The samplers' conversions (`predict_*`, `q_posterior`) take the
step's timestep as a host int, as the loops know it, and read the tables'
float32 entries directly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule (float64). reference: utils_diffusion.py:31-53."""
    if schedule == "linear":
        return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    raise ValueError(f"unknown beta schedule '{schedule}'")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Zero-terminal-SNR rescale (arXiv 2305.08891 alg. 1)."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    a0, aT = abar_sqrt[0].copy(), abar_sqrt[-1].copy()
    abar_sqrt = (abar_sqrt - aT) * (a0 / (a0 - aT))
    abar = abar_sqrt**2
    alphas = np.concatenate([abar[0:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


def make_ddim_timesteps(method: str, num_ddim_timesteps: int, num_ddpm_timesteps: int) -> np.ndarray:
    """DDIM timestep subset (int64). reference: utils_diffusion.py:56-76."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        steps = np.asarray(list(range(0, num_ddpm_timesteps, c))) + 1
        if steps[-1] >= num_ddpm_timesteps:
            steps = np.unique(np.minimum(steps, num_ddpm_timesteps - 1))
    elif method == "uniform_trailing":
        c = num_ddpm_timesteps / num_ddim_timesteps
        steps = np.flip(np.round(np.arange(num_ddpm_timesteps, 0, -c))).astype(np.int64) - 1
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2).astype(int) + 1
    else:
        raise NotImplementedError(f"unknown ddim discretization '{method}'")
    return steps.astype(np.int64)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers of the reference (ddpm3d.py:125-188) that the port
    reads, as float32 host arrays."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear", linear_start: float = 1e-4,
               linear_end: float = 2e-2, cosine_s: float = 8e-3, rescale_betas_zero_snr: bool = False,
               parameterization: str = "eps") -> "DiffusionSchedule":
        if parameterization not in ("eps", "x0", "v"):
            raise NotImplementedError(f"parameterization '{parameterization}'")
        betas = make_beta_schedule(beta_schedule, timesteps, linear_start, linear_end, cosine_s)
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
        if parameterization != "v":
            sqrt_recip = np.sqrt(1.0 / alphas_cumprod)
            sqrt_recipm1 = np.sqrt(1.0 / alphas_cumprod - 1)
        else:
            sqrt_recip = sqrt_recipm1 = np.zeros_like(alphas_cumprod)
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=f32(sqrt_recip),
            sqrt_recipm1_alphas_cumprod=f32(sqrt_recipm1),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
        )


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    """Per-DDIM-step float32 tables (ascending DDPM timesteps); with a
    model's dynamic-rescale table (reference samplers/ddim.py:31-33),
    `scale_arr` at each step's timestep and `scale_arr_prev` the same
    shifted by one step, else None."""

    timesteps: np.ndarray  # (S,) int64
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray
    scale_arr: Optional[np.ndarray] = None
    scale_arr_prev: Optional[np.ndarray] = None

    @property
    def num_steps(self) -> int:
        return self.timesteps.shape[0]

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_steps: int, spacing: str = "uniform",
               eta: float = 0.0, scale_arr: Optional[np.ndarray] = None) -> "DDIMSchedule":
        alphacums = np.asarray(schedule.alphas_cumprod, dtype=np.float64)
        ts = make_ddim_timesteps(spacing, num_steps, schedule.num_timesteps)
        alphas = alphacums[ts]
        alphas_prev = np.concatenate([alphacums[0:1], alphacums[ts[:-1]]])
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        sarr = sarr_prev = None
        if scale_arr is not None:
            s = np.asarray(scale_arr, dtype=np.float64)[ts]
            sarr, sarr_prev = f32(s), f32(np.concatenate([s[:1], s[:-1]]))
        return cls(timesteps=ts, alphas=f32(alphas), alphas_prev=f32(alphas_prev),
                   sqrt_one_minus_alphas=f32(np.sqrt(1.0 - alphas)), sigmas=f32(sigmas),
                   scale_arr=sarr, scale_arr_prev=sarr_prev)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embedding, [cos | sin] order: (N,) -> (N, dim) float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                           device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def sinusoidal_positional_encoding(length: int, dim: int) -> np.ndarray:
    """Interleaved sin/cos table (length, dim) f32: even dims sin, odd dims
    cos (the pose encoder's PositionalEncoding, reference
    model/modules/camera_pose_encoder.py:81-99)."""
    position = np.arange(length)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, dim, 2).astype(np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float):
    """Guidance-rescale trick (arXiv 2305.08891 §3.4)."""
    axes = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=axes, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=axes, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def extract(buf: np.ndarray, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Per-timestep f32 scalars of a schedule table, shaped to broadcast
    over a rank-`ndim` batch (the reference's `extract_into_tensor`)."""
    out = torch.as_tensor(buf, device=t.device)[t.long()]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(schedule: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor):
    """Forward diffusion q(x_t | x_0). reference: ddpm3d.py:307-312."""
    return (extract(schedule.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
            + extract(schedule.sqrt_one_minus_alphas_cumprod, t, x_start.dim()) * noise)


def get_v(schedule: DiffusionSchedule, x: torch.Tensor, noise: torch.Tensor, t: torch.Tensor):
    """v-parameterization target. reference: ddpm3d.py (get_v)."""
    return (extract(schedule.sqrt_alphas_cumprod, t, x.dim()) * noise
            - extract(schedule.sqrt_one_minus_alphas_cumprod, t, x.dim()) * x)


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor, step: int, noise: torch.Tensor):
    """x0-hat from an eps prediction at the host timestep `step`. reference: ddpm3d.py:233-238."""
    return (float(schedule.sqrt_recip_alphas_cumprod[step]) * x_t
            - float(schedule.sqrt_recipm1_alphas_cumprod[step]) * noise)


def q_posterior(schedule: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor, step: int):
    """(mean, clipped log-variance) of q(x_{t-1} | x_t, x0) at the host
    timestep `step`; the log-variance is a float32 host scalar. reference:
    ddpm3d.py:254-261."""
    mean = float(schedule.posterior_mean_coef1[step]) * x_start + float(schedule.posterior_mean_coef2[step]) * x_t
    return mean, schedule.posterior_log_variance_clipped[step]


def predict_start_from_z_and_v(schedule: DiffusionSchedule, x_t: torch.Tensor, step: int, v: torch.Tensor):
    return float(schedule.sqrt_alphas_cumprod[step]) * x_t - float(schedule.sqrt_one_minus_alphas_cumprod[step]) * v


def predict_eps_from_z_and_v(schedule: DiffusionSchedule, x_t: torch.Tensor, step: int, v: torch.Tensor):
    return float(schedule.sqrt_alphas_cumprod[step]) * v + float(schedule.sqrt_one_minus_alphas_cumprod[step]) * x_t
