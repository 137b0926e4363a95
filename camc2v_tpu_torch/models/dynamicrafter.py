"""DynamiCrafter image-to-video model (`camc2v_tpu/models/dynamicrafter.py`).

One `nn.Module` owns the UNet, the VAE, the CLIP text and vision towers and
the Resampler; methods mirror the JAX assembly's generation path:
`prepare_batch` -> `build_uncond` -> `build_guided_fn` -> `ddim_sample` ->
`decode_first_stage`, driven by `sample`.

Batch contract (channels-last, as in the JAX package):
  video (B, T, H, W, 3) float in [-1, 1]; caption_tokens (B, 77) int CLIP BPE
  ids; frame_stride (B,) int. Camera models (`models/camera_base.py`) add
  their keys and fill the `camera_condition` hook, whose payload rides
  cond["camera"] into every UNet call.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from camc2v_tpu_torch.config import DynamiCrafterConfig
from camc2v_tpu_torch.core import distributions as D
from camc2v_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule, rescale_noise_cfg
from camc2v_tpu_torch.models.sampler import ddim_sample
from camc2v_tpu_torch.nn.clip import CLIPTextTower, CLIPVisionTower, clip_preprocess
from camc2v_tpu_torch.nn.resampler import Resampler
from camc2v_tpu_torch.nn.unet3d import UNetModel
from camc2v_tpu_torch.nn.vae import AutoencoderKL


def empty_prompt_tokens(vocab_size: int, context_length: int) -> tuple[int, ...]:
    """CLIP BPE ids of the empty prompt: <sot>, <eot>, then 0 padding."""
    return (vocab_size - 2, vocab_size - 1) + (0,) * (context_length - 2)


class DynamiCrafter(nn.Module):
    def __init__(self, config: DynamiCrafterConfig, dtype=torch.bfloat16):
        super().__init__()
        if config.interp_mode or config.perframe_ae or config.use_dynamic_rescale:
            raise NotImplementedError("DynamiCrafter: interp_mode, perframe_ae and dynamic rescale are not ported")
        self.config = config
        self.dtype = dtype
        self.unet = UNetModel(config.unet, dtype=dtype)
        self.vae = AutoencoderKL(config.vae, dtype=dtype)
        self.clip_text = CLIPTextTower(config.clip_text, dtype=dtype)
        self.clip_vision = CLIPVisionTower(config.clip_vision, dtype=dtype)
        rs = config.resampler
        self.image_proj = Resampler(
            dim=rs.dim, depth=rs.depth, dim_head=rs.dim_head, heads=rs.heads, num_queries=rs.num_queries,
            embedding_dim=rs.embedding_dim, output_dim=rs.output_dim, ff_mult=rs.ff_mult,
            video_length=rs.video_length, use_timestep_emb=rs.use_timestep_emb, dtype=dtype,
        )
        self.schedule = DiffusionSchedule.create(
            timesteps=config.timesteps, beta_schedule=config.beta_schedule,
            linear_start=config.linear_start, linear_end=config.linear_end,
            rescale_betas_zero_snr=config.rescale_betas_zero_snr, parameterization=config.parameterization,
        )

    # ---------------------------------------------------------- first stage
    def encode_first_stage(self, video: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, T, H, W, 3) -> (B, T, h, w, 4) scaled latents (posterior mode
        without a generator, a sample with one)."""
        b, t = video.shape[:2]
        moments = self.vae.encode(video.reshape(b * t, *video.shape[2:]))
        z = D.mode(moments) if generator is None else D.sample(moments, generator)
        z = z * self.config.scale_factor
        return z.reshape(b, t, *z.shape[1:]).float()

    def decode_first_stage(self, z: torch.Tensor):
        b, t = z.shape[:2]
        x = self.vae.decode(z.reshape(b * t, *z.shape[2:]) / self.config.scale_factor)
        return x.reshape(b, t, *x.shape[1:]).float()

    # --------------------------------------------------------- conditioning
    def encode_text(self, tokens: torch.Tensor):
        return self.clip_text(tokens).float()

    def embed_images(self, frames: torch.Tensor):
        """(N, H, W, 3) [-1, 1] -> (N, num_queries * video_length, output_dim)."""
        return self.image_proj(self.clip_vision(clip_preprocess(frames))).float()

    def _null_tokens(self, device):
        ct = self.config.clip_text
        return torch.tensor(empty_prompt_tokens(ct.vocab_size, ct.context_length), dtype=torch.long,
                            device=device)[None]

    def prepare_batch(self, batch: dict, *, prefetch_uncond: bool = False,
                      perturb_noise: Optional[torch.Tensor] = None):
        """Generation conditioning (`prepare_batch` with need_full_z=False,
        cond frame 0, no CFG dropout): only the conditioning frame is
        VAE-encoded (posterior mode). Returns (latent shape, cond)."""
        video = batch["video"]
        b, t = video.shape[:2]
        img = video[:, 0]  # cond_frame_index 0
        z_cond = self.encode_first_stage(img[:, None])[:, 0]
        # one text-tower call for [captions | empty prompt]
        tokens = torch.cat([batch["caption_tokens"].long(), self._null_tokens(video.device)])
        text = self.encode_text(tokens)
        cond_emb, null_prompt = text[:-1], text[-1:]
        cond = {}
        if prefetch_uncond:
            emb_all = self.embed_images(torch.cat([img, torch.zeros_like(img[:1])]))
            img_emb, uc_img = emb_all[:b], emb_all[b:]
            cond["_uncond"] = {
                "img_emb": uc_img.expand(b, -1, -1),
                "prompt_emb": null_prompt.expand(b, -1, -1),
            }
        else:
            img_emb = self.embed_images(img)
        cond["c_concat"] = z_cond[:, None].expand(b, t, *z_cond.shape[1:])
        cond["c_crossattn"] = torch.cat([cond_emb, img_emb], dim=1)
        cond_frame_index = torch.zeros(b, dtype=torch.long, device=video.device)
        camera = self.camera_condition(batch, cond_frame_index, perturb_noise=perturb_noise)
        if camera is not None:
            cond["camera"] = camera
        return (b, t, *z_cond.shape[1:]), cond

    def camera_condition(self, batch: dict, cond_frame_index: torch.Tensor, *,
                         perturb_noise: Optional[torch.Tensor] = None) -> Optional[dict]:
        """Hook of the camera models (reference model/base.py:475-476): the
        UNet's camera payload, or None."""
        return None

    def build_uncond(self, cond: dict, batch_size: int, image_hw) -> dict:
        """uncond_type 'empty_seq': empty prompt + zero image."""
        if self.config.uncond_type != "empty_seq":
            raise NotImplementedError(f"uncond_type '{self.config.uncond_type}' is not ported")
        pre = cond.get("_uncond")
        if pre is not None:
            uc_prompt, uc_img = pre["prompt_emb"], pre["img_emb"]
        else:
            device = cond["c_concat"].device
            uc_prompt = self.encode_text(self._null_tokens(device)).expand(batch_size, -1, -1)
            uc_img = self.embed_images(torch.zeros(batch_size, *image_hw, 3, device=device))
        uc = {k: v for k, v in cond.items() if k != "_uncond"}
        uc["c_crossattn"] = torch.cat([uc_prompt, uc_img], dim=1)
        return uc

    def get_fs(self, batch: dict):
        key = "frame_stride" if self.config.fps_condition_type == "fs" else "fps"
        return batch[key].to(torch.int32)

    # -------------------------------------------------------------- denoise
    def apply_model(self, x_noisy, t, cond: dict, fs=None):
        xc = torch.cat([x_noisy, cond["c_concat"]], dim=-1)
        return self.unet(xc, t, cond["c_crossattn"], fs, cond.get("camera"),
                         context_mask=cond.get("c_crossattn_mask"))

    def build_guided_fn(self, cond: dict, uc: Optional[dict], fs, *, guidance_scale: float = 1.0,
                        guidance_rescale: float = 0.0):
        """Guided denoiser closure. When the cond and uncond contexts have one
        shape, both run as ONE batch-2B UNet call, the camera payload stacked
        with them (the uncond shares cond's geometry); otherwise (CamContextI2V's
        multi-frame context against a single-frame uncond) two calls."""
        if uc is None or guidance_scale == 1.0:
            return lambda x, t: self.apply_model(x, t, cond, fs)
        b = cond["c_concat"].shape[0]
        if uc["c_crossattn"].shape == cond["c_crossattn"].shape:
            keys = ("c_concat", "c_crossattn") + (("camera",) if "camera" in cond else ())
            stacked = {k: _stack(cond[k], uc[k]) for k in keys}
            fs2 = None if fs is None else torch.cat([fs, fs])

            def eps_pair(x, t):
                out = self.apply_model(torch.cat([x, x]), torch.cat([t, t]), stacked, fs2)
                return out[:b], out[b:]
        else:
            def eps_pair(x, t):
                return self.apply_model(x, t, cond, fs), self.apply_model(x, t, uc, fs)

        def model_out_fn(x, t):
            e_c, e_u = eps_pair(x, t)
            combined = e_u + guidance_scale * (e_c - e_u)
            if guidance_rescale > 0.0:
                combined = rescale_noise_cfg(combined, e_c, guidance_rescale)
            return combined

        return model_out_fn

    # ----------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(self, batch: dict, *, generator: Optional[torch.Generator] = None, ddim_steps: int = 25,
               ddim_eta: float = 1.0, guidance_scale: float = 7.5, guidance_rescale: float = 0.7,
               timestep_spacing: str = "uniform_trailing", decode: bool = True,
               camera_cfg: float = 1.0, x_T: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None, perturb_noise: Optional[torch.Tensor] = None):
        """DDIM CFG sampling -> decoded video (B, T, H, W, 3).

        x_T / step_noise: optional initial latents and per-step standard-normal
        draws in place of `generator`; perturb_noise: the camera models'
        zero-translation perturbation draws (test hooks)."""
        if camera_cfg != 1.0:
            raise NotImplementedError("sample: camera_cfg != 1.0 (the camera-free third pass) is not ported")
        shape, cond = self.prepare_batch(batch, prefetch_uncond=guidance_scale != 1.0, perturb_noise=perturb_noise)
        b = shape[0]
        fs = self.get_fs(batch)
        uc = self.build_uncond(cond, b, batch["video"].shape[2:4]) if guidance_scale != 1.0 else None
        cond.pop("_uncond", None)
        fn = self.build_guided_fn(cond, uc, fs, guidance_scale=guidance_scale,
                                  guidance_rescale=guidance_rescale)
        ddim = DDIMSchedule.create(self.schedule, ddim_steps, timestep_spacing, ddim_eta)
        device = batch["video"].device
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        samples = ddim_sample(ddim, x_T, fn, generator=generator, step_noise=step_noise)
        return self.decode_first_stage(samples) if decode else samples


def _stack(a: Any, b: Any) -> Any:
    """Concatenate two payloads of the same structure (dicts and tuples of
    tensors) along the batch axis."""
    if isinstance(a, dict):
        return {k: _stack(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_stack(x, y) for x, y in zip(a, b))
    return torch.cat([a, b])
