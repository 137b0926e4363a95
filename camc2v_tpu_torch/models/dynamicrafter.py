"""DynamiCrafter image-to-video model (`camc2v_tpu/models/dynamicrafter.py`).

One `nn.Module` owns the UNet, the VAE, the CLIP text and vision towers and
the Resampler; methods mirror the JAX assembly's generation path:
`prepare_batch` -> `build_uncond` -> `build_guided_fn` (CFG, camera CFG,
`cfg_interval`) -> `ddim_sample`, `dpmpp_2m_sample` or `p_sample_loop` ->
`decode_first_stage`, driven by `sample`; and its training loss:
`prepare_batch(random_uncond=True, need_full_z=True)` -> `p_losses`
(q_sample, the UNet with `deterministic=False`, `get_loss` against the
`eps`, `x0` or `v` target), driven by `training_loss`. The random draws of
the loss (the conditioning frame with `rand_cond_frame`, VAE posterior
sample, CFG dropout, timestep, noise) come from the `generator` the caller
passes, the JAX rng's counterpart; the UNet's dropout draws from the global
RNG.
The VAE encoder and the CLIP towers are frozen and take data: they run under
`torch.no_grad()` (the JAX `stop_gradient` on the text embedding).

Batch contract (channels-last, as in the JAX package):
  video (B, T, H, W, 3) float in [-1, 1]; caption_tokens (B, 77) int CLIP BPE
  ids; frame_stride (B,) int. Camera models (`models/camera_base.py`) add
  their keys and fill the `camera_condition` hook, whose payload rides
  cond["camera"] into every UNet call.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch import nn

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.config import DynamiCrafterConfig
from camc2v_tpu_torch.core import distributions as D
from camc2v_tpu_torch.core.schedules import (DDIMSchedule, DiffusionSchedule, extract, get_v, q_sample,
                                             rescale_noise_cfg)
from camc2v_tpu_torch.models.sampler import SamplerOptions, ddim_sample, dpmpp_2m_sample, p_sample_loop
from camc2v_tpu_torch.nn.clip import CLIPTextTower, CLIPVisionTower, clip_preprocess
from camc2v_tpu_torch.nn.epipolar import add_precomputed_penalties
from camc2v_tpu_torch.nn.resampler import Resampler
from camc2v_tpu_torch.nn.unet3d import UNetModel
from camc2v_tpu_torch.nn.vae import AutoencoderKL


def empty_prompt_tokens(vocab_size: int, context_length: int) -> tuple[int, ...]:
    """CLIP BPE ids of the empty prompt: <sot>, <eot>, then 0 padding."""
    return (vocab_size - 2, vocab_size - 1) + (0,) * (context_length - 2)


class DynamiCrafter(nn.Module):
    def __init__(self, config: DynamiCrafterConfig, dtype=torch.bfloat16):
        super().__init__()
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
        self.scale_arr = None
        if config.use_dynamic_rescale:
            # reference ddpm3d.py:524-528: a ramp 1.0 -> base_scale over the
            # first turning_step timesteps, then base_scale
            ramp = np.linspace(1.0, config.base_scale, config.turning_step)
            rest = np.full(config.timesteps, config.base_scale)
            self.scale_arr = np.concatenate([ramp, rest])[: config.timesteps].astype(np.float32)

    # ---------------------------------------------------------- first stage
    @torch.no_grad()
    def encode_first_stage(self, video: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(B, T, H, W, 3) -> (B, T, h, w, 4) scaled latents (posterior mode
        without a generator, a sample with one). With `perframe_ae` the
        encoder takes one frame at a time (reference ddpm3d.py:633-641)."""
        b, t = video.shape[:2]
        frames = video.reshape(b * t, *video.shape[2:])
        if self.config.perframe_ae:
            moments = torch.cat([self.vae.encode(frames[i:i + 1]) for i in range(b * t)])
        else:
            moments = self.vae.encode(frames)
        z = D.mode(moments) if generator is None else D.sample(moments, generator)
        z = z * self.config.scale_factor
        return z.reshape(b, t, *z.shape[1:]).float()

    def decode_first_stage(self, z: torch.Tensor):
        b, t = z.shape[:2]
        zf = z.reshape(b * t, *z.shape[2:]) / self.config.scale_factor
        if self.config.perframe_ae:  # reference ddpm3d.py:657-663
            x = torch.cat([self.vae.decode(zf[i:i + 1]) for i in range(b * t)])
        else:
            x = self.vae.decode(zf)
        return x.reshape(b, t, *x.shape[1:]).float()

    # --------------------------------------------------------- conditioning
    @torch.no_grad()
    def encode_text(self, tokens: torch.Tensor):
        return self.clip_text(tokens).float()

    def embed_images(self, frames: torch.Tensor):
        """(N, H, W, 3) [-1, 1] -> (N, num_queries * video_length, output_dim);
        the Resampler (`image_proj`) is the trainable part."""
        with torch.no_grad():
            tokens = self.clip_vision(clip_preprocess(frames))
        return self.image_proj(tokens).float()

    def _null_tokens(self, device):
        ct = self.config.clip_text
        return torch.tensor(empty_prompt_tokens(ct.vocab_size, ct.context_length), dtype=torch.long,
                            device=device)[None]

    def cfg_dropout_masks(self, batch_size: int, generator: Optional[torch.Generator], device):
        """(prompt_mask (B, 1, 1) bool, input_mask (B, 1, 1, 1) f32) of the
        classifier-free-guidance dropout (reference model/base.py:263-273):
        one uniform draw drives both; no draw (no dropout) without a generator."""
        p = self.config.uncond_prob
        if generator is None:
            rn = torch.ones(batch_size, device=device)
        else:
            rn = torch.rand(batch_size, generator=generator, device=device)
        prompt_mask = (rn < 2 * p)[:, None, None]
        input_drop = ((rn >= p) & (rn < 3 * p)).float()
        return prompt_mask, 1.0 - input_drop[:, None, None, None]

    def _text_condition(self, batch: dict, b: int, generator, random_uncond: bool, device):
        """(prompt embedding after the CFG dropout, the empty prompt's
        embedding, the image input mask): one text-tower call for
        [captions | empty prompt]."""
        tokens = torch.cat([batch["caption_tokens"].long(), self._null_tokens(device)])
        text = self.encode_text(tokens)
        cond_emb, null_prompt = text[:-1], text[-1:]
        prompt_mask, input_mask = self.cfg_dropout_masks(b, generator if random_uncond else None, device)
        return torch.where(prompt_mask, null_prompt, cond_emb), null_prompt, input_mask

    def cond_frame_indices(self, b: int, device, generator: Optional[torch.Generator] = None,
                           rand_cond_frame: Optional[bool] = None, cond_frame_index=None) -> torch.Tensor:
        """(B,) long conditioning-frame indices: the given ones (a (B,)
        tensor or one int for every sample), else with `rand_cond_frame`
        (None: the config's) and a generator one uniform draw in
        [0, video_length) per sample, else frame 0 (reference
        model/base.py:237-262)."""
        if cond_frame_index is not None:
            if isinstance(cond_frame_index, (int, np.integer)):
                return torch.full((b,), cond_frame_index, dtype=torch.long, device=device)
            return cond_frame_index.to(device=device, dtype=torch.long)
        rcf = self.config.rand_cond_frame if rand_cond_frame is None else rand_cond_frame
        if rcf and generator is not None:
            return torch.randint(0, self.config.video_length, (b,), generator=generator, device=device)
        return torch.zeros(b, dtype=torch.long, device=device)

    def prepare_batch(self, batch: dict, generator: Optional[torch.Generator] = None, *,
                      random_uncond: bool = False, rand_cond_frame: Optional[bool] = None,
                      cond_frame_index=None, enable_camera_condition: bool = True,
                      trace_scale_factor: float = 1.0, need_full_z: bool = False, prefetch_uncond: bool = False,
                      perturb_noise: Optional[torch.Tensor] = None):
        """(z, cond) (reference model/base.py:237-344).

        generator: the conditioning frame is drawn from it with
        `rand_cond_frame` (first), the VAE posterior is sampled with it (its
        mode without one) and, with `random_uncond`, the CFG dropout draws
        from it. cond_frame_index / rand_cond_frame: see `cond_frame_indices`.
        need_full_z: every frame is VAE-encoded and z holds the clean latents
        (training, the latent surgery; forced by `interp_mode`); otherwise
        only the conditioning frame is encoded and z is a broadcast view of
        it carrying the latent shape. cond holds c_concat, c_crossattn,
        c_cond_frame_index, origin_z0 (z with need_full_z, else None) and,
        unless enable_camera_condition is False, the camera payload, whose
        relative translations are scaled by trace_scale_factor."""
        cfg = self.config
        video = batch["video"]
        b, t = video.shape[:2]
        need_full_z = need_full_z or cfg.interp_mode  # first/last-frame concat needs every latent
        idx = self.cond_frame_indices(b, video.device, generator, rand_cond_frame, cond_frame_index)
        img = take_frame(video, idx)
        if need_full_z:
            z = self.encode_first_stage(video, generator)
            z_cond = take_frame(z, idx)
        else:
            z_cond = self.encode_first_stage(img[:, None], generator)[:, 0]
            z = z_cond[:, None].expand(b, t, *z_cond.shape[1:])
        prompt_emb, null_prompt, input_mask = self._text_condition(batch, b, generator, random_uncond, video.device)
        img = input_mask * img
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
        if cfg.interp_mode:
            frame = torch.arange(t, device=video.device)
            first_last = (frame == 0) | (frame == t - 1)
            cond["c_concat"] = torch.where(first_last[None, :, None, None, None], z, 0.0)
        else:
            cond["c_concat"] = z_cond[:, None].expand(b, t, *z_cond.shape[1:])
        cond["c_cond_frame_index"] = idx
        cond["origin_z0"] = z if need_full_z else None
        cond["c_crossattn"] = torch.cat([prompt_emb, img_emb], dim=1)
        if enable_camera_condition:
            camera = self.camera_condition(batch, idx, trace_scale_factor=trace_scale_factor,
                                           perturb_noise=perturb_noise)
            if camera is not None:
                cond["camera"] = camera
        return z, cond

    def camera_condition(self, batch: dict, cond_frame_index: torch.Tensor, *, trace_scale_factor: float = 1.0,
                         perturb_noise: Optional[torch.Tensor] = None) -> Optional[dict]:
        """Hook of the camera models (reference model/base.py:475-476): the
        UNet's camera payload, or None."""
        return None

    def build_uncond(self, cond: dict, batch_size: int, image_hw,
                     negative_prompt_tokens: Optional[torch.Tensor] = None) -> dict:
        """The unconditional inputs (reference model/base.py:418-447): the
        prompt part by `uncond_type` ('empty_seq': the empty prompt;
        'zero_embed': zeros; 'negative_prompt', or any type when
        negative_prompt_tokens are given: those tokens' embedding), the image
        part the zero image's; cond's other inputs shared."""
        ut = self.config.uncond_type
        pre = cond.get("_uncond")
        device = cond["c_concat"].device
        if negative_prompt_tokens is not None or ut == "negative_prompt":
            assert negative_prompt_tokens is not None, "negative_prompt mode needs tokens"
            uc_prompt = self.encode_text(negative_prompt_tokens.to(device).long())
        elif ut == "zero_embed":
            uc_prompt = torch.zeros_like(cond["c_crossattn"][:, : self.config.clip_text.context_length])
        elif pre is not None:  # empty_seq, prefetched
            uc_prompt = pre["prompt_emb"]
        else:  # empty_seq
            uc_prompt = self.encode_text(self._null_tokens(device)).expand(batch_size, -1, -1)
        if pre is not None:
            uc_img = pre["img_emb"]
        else:
            uc_img = self.embed_images(torch.zeros(batch_size, *image_hw, 3, device=device))
        uc = {k: v for k, v in cond.items() if k not in ("_uncond", "c_crossattn_mask")}
        uc["c_crossattn"] = torch.cat([uc_prompt, uc_img], dim=1)  # single-frame: never padded
        return uc

    def get_fs(self, batch: dict):
        key = "frame_stride" if self.config.fps_condition_type == "fs" else "fps"
        return batch[key].to(torch.int32)

    # -------------------------------------------------------------- denoise
    def apply_model(self, x_noisy, t, cond: dict, fs=None, *, deterministic: bool = True):
        """The UNet on [x_noisy | c_concat]; deterministic=False (training
        only) turns on its dropout and block remat."""
        xc = torch.cat([x_noisy, cond["c_concat"]], dim=-1)
        return self.unet(xc, t, cond["c_crossattn"], fs, cond.get("camera"),
                         context_mask=cond.get("c_crossattn_mask"), deterministic=deterministic)

    # ----------------------------------------------------------------- loss
    def get_loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Per-element loss, no reduction (reference camcontexti2v.py:795-815);
        l2_log weights frame i by log10(i + 2), normalised."""
        lt = self.config.loss_type
        if lt == "l1":
            return (target - pred).abs()
        if lt == "l2":
            return (target - pred) ** 2
        if lt == "l2_log":
            t = pred.shape[1]
            w = torch.log10(torch.arange(2, t + 2, dtype=torch.float32, device=pred.device))
            w = w / w.sum()
            return w[None, :, None, None, None] * (target - pred) ** 2
        raise NotImplementedError(f"loss type '{lt}'")

    def p_losses(self, z: torch.Tensor, cond: dict, t: torch.Tensor, noise: torch.Tensor, fs=None, *,
                 deterministic: bool = False) -> tuple[torch.Tensor, dict]:
        """The loss at timesteps t with the given noise (reference
        ddpm3d.py:741-785): with dynamic rescale z is scaled by the
        timestep's `scale_arr` first; the target is the noise (`eps`), z
        (`x0`) or `get_v` (`v`). (loss, {"loss_simple", "loss"})."""
        cfg = self.config
        if cfg.use_dynamic_rescale:
            z = z * extract(self.scale_arr, t, z.dim())
        x_noisy = q_sample(self.schedule, z, t, noise)
        model_output = self.apply_model(x_noisy, t, cond, fs, deterministic=deterministic)
        if cfg.parameterization == "x0":
            target = z
        elif cfg.parameterization == "eps":
            target = noise
        elif cfg.parameterization == "v":
            target = get_v(self.schedule, z, noise, t)
        else:
            raise NotImplementedError(cfg.parameterization)
        loss_simple = self.get_loss(model_output, target).mean(dim=(1, 2, 3, 4))
        loss = loss_simple.mean()
        return loss, {"loss_simple": loss_simple.mean().detach(), "loss": loss.detach()}

    def training_loss(self, batch: dict, generator: torch.Generator, *, deterministic: bool = False,
                      **prepare_kwargs) -> tuple[torch.Tensor, dict]:
        """The train-step loss (reference shared_step, camcontexti2v.py:779-793):
        conditioning with CFG dropout (and the config's `rand_cond_frame`)
        and every frame encoded, a uniform timestep and standard-normal noise
        per sample (plus the offset noise of `noise_strength`), the UNet in
        training mode (`deterministic=True`: dropout and block remat off, the
        validation loss). `prepare_kwargs` carries per-phase flags
        (CamContextI2V's `adaptor_use_mask`)."""
        cfg = self.config
        z, cond = self.prepare_batch(batch, generator, random_uncond=True, need_full_z=True, **prepare_kwargs)
        b = z.shape[0]
        t = torch.randint(0, cfg.timesteps, (b,), generator=generator, device=z.device)
        noise = torch.randn(z.shape, generator=generator, device=z.device)
        if cfg.noise_strength > 0:
            offset = torch.randn((b, z.shape[1], 1, 1, z.shape[-1]), generator=generator, device=z.device)
            noise = noise + cfg.noise_strength * offset
        return self.p_losses(z, cond, t, noise, self.get_fs(batch), deterministic=deterministic)

    def _pad_uncond_for_fusion(self, cond: dict, uc: dict) -> Optional[tuple[dict, dict]]:
        """(cond, uc) with the shorter single-frame-set uncond context padded
        to cond's length, so both stack into one batch-2B call, exactly
        (the JAX `_pad_uncond_for_fusion`): the UNet routes the uncond's
        image tokens per frame, and the padded form says the same with a
        (B, T, L) validity mask (frame i sees the text and its own image
        tokens, the padding nothing), beside an all-true mask for cond.
        None when the uncond is not of that form."""
        ucfg = self.config.unet
        lt, ipf, t = ucfg.text_context_len, ucfg.img_tokens_per_frame, self.config.video_length
        cc, cu = cond["c_crossattn"], uc["c_crossattn"]
        b, lc = cc.shape[:2]
        lu = cu.shape[1]
        if lu >= lc or lu != lt + t * ipf:
            return None
        dev = cu.device
        uc = dict(uc)
        uc["c_crossattn"] = torch.cat([cu, cu.new_zeros(b, lc - lu, cu.shape[-1])], dim=1)
        tok = torch.arange(lc - lt, device=dev)
        frame = torch.arange(t, device=dev)
        per_frame = (tok[None] >= frame[:, None] * ipf) & (tok[None] < (frame[:, None] + 1) * ipf)
        uc_mask = torch.cat([torch.ones(t, lt, dtype=torch.bool, device=dev), per_frame], dim=1)
        uc["c_crossattn_mask"] = uc_mask[None].expand(b, t, lc)
        cond = dict(cond)
        cmask = cond.get("c_crossattn_mask")
        cond["c_crossattn_mask"] = (torch.ones(b, t, lc, dtype=torch.bool, device=dev) if cmask is None
                                    else cmask.bool()[:, None].expand(b, t, lc))
        return cond, uc

    def build_guided_fn(self, cond: dict, uc: Optional[dict], fs, *, guidance_scale: float = 1.0,
                        guidance_rescale: float = 0.0, camera_cfg: float = 1.0,
                        camera_cfg_scheduler: str = "constant",
                        cfg_interval: Optional[tuple[float, float]] = None):
        """Guided denoiser closure (reference samplers/ddim.py:253-283).

        When the cond and uncond contexts have one shape, both run as ONE
        batch-2B UNet call, everything stacked but the epipolar penalties,
        which the uncond shares with cond (K6p reads the (B, ...) copy for
        the 2B batch); otherwise (CamContextI2V's multi-frame context against
        a single-frame uncond) two calls, or with `CAMC2V_FUSED_CFG=1` the
        uncond padded to cond's length (`_pad_uncond_for_fusion`) and one
        call.

        camera_cfg != 1 on a cond with a camera payload adds a third call on
        that cond without the camera (after the padding: its mask is the
        padded one, and it carries no penalties), weighted by
        (camera_cfg - 1) w, w = 1 ('constant') or cos((1 - t/999) pi/2)
        ('cosine'). cfg_interval=(lo, hi): steps whose timestep is outside
        [lo, hi] run the conditional call alone (on the cond as given).

        The closure is `fn(x, t, step)`, t the step's timestep on the device
        and `step` the same as a host int, so neither the cosine weight nor
        the interval reads t back from the device."""
        cond = _model_inputs(cond)
        cond_entry = cond
        if uc is None or guidance_scale == 1.0:
            return lambda x, t, step: self.apply_model(x, t, cond, fs)
        uc = _model_inputs(uc)
        b = cond["c_concat"].shape[0]
        if uc["c_crossattn"].shape != cond["c_crossattn"].shape and ops.switch_on("CAMC2V_FUSED_CFG"):
            padded = self._pad_uncond_for_fusion(cond, uc)
            if padded is not None:
                cond, uc = padded
        if uc["c_crossattn"].shape == cond["c_crossattn"].shape:
            cond, shared = _strip_penalties(cond)
            stacked = _stack(cond, _strip_penalties(uc)[0])
            for ds, pen in shared.items():
                stacked["camera"]["epi_prep"][ds]["penalties"] = pen
            fs2 = None if fs is None else torch.cat([fs, fs])

            def eps_pair(x, t):
                out = self.apply_model(torch.cat([x, x]), torch.cat([t, t]), stacked, fs2)
                return out[:b], out[b:]
        else:
            def eps_pair(x, t):
                return self.apply_model(x, t, cond, fs), self.apply_model(x, t, uc, fs)

        do_camera_cfg = camera_cfg != 1.0 and cond.get("camera") is not None
        cond_nc = None
        if do_camera_cfg:
            if camera_cfg_scheduler not in ("constant", "cosine"):
                raise NotImplementedError(camera_cfg_scheduler)
            cond_nc = {k: v for k, v in cond.items() if k != "camera"}

        def guided(x, t, step):
            e_c, e_u = eps_pair(x, t)
            combined = e_u + guidance_scale * (e_c - e_u)
            if do_camera_cfg:
                e_nc = self.apply_model(x, t, cond_nc, fs)
                w = np.float32(1.0) if camera_cfg_scheduler == "constant" else np.cos(
                    (np.float32(1.0) - np.float32(step) / np.float32(999.0)) * np.float32(math.pi / 2))
                combined = combined + float(np.float32(camera_cfg - 1.0) * w) * (e_c - e_nc)
            if guidance_rescale > 0.0:
                combined = rescale_noise_cfg(combined, e_c, guidance_rescale)
            return combined

        if cfg_interval is None:
            return guided
        lo, hi = cfg_interval

        def fn(x, t, step):
            if lo <= step <= hi:
                return guided(x, t, step)
            return self.apply_model(x, t, cond_entry, fs)
        return fn

    # ----------------------------------------------------------------- sample
    @torch.no_grad()
    def sample(self, batch: dict, *, generator: Optional[torch.Generator] = None, ddim_steps: int = 25,
               ddim_eta: float = 1.0, sampler: str = "ddim", guidance_scale: float = 7.5,
               guidance_rescale: float = 0.0, cfg_interval: Optional[tuple[float, float]] = None,
               timestep_spacing: str = "uniform", camera_cfg: float = 1.0, camera_cfg_scheduler: str = "constant",
               enable_camera_condition: bool = True, cond_frame_index=None, trace_scale_factor: float = 1.0,
               paste_cond_frame: bool = False, num_overlap: int = 0, blend_mask: Optional[torch.Tensor] = None,
               blend_x0: Optional[torch.Tensor] = None, clean_cond: bool = False,
               negative_prompt_tokens: Optional[torch.Tensor] = None, decode: bool = True,
               return_cond: bool = False, x_T: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence] = None, perturb_noise: Optional[torch.Tensor] = None):
        """Guided sampling -> decoded video (B, T, H, W, 3) (reference
        log_images -> sample_log -> DDIMSampler.sample, model/base.py:346-472),
        with the JAX package's keywords and defaults.

        sampler: "ddim" (eta noise, the latent surgery, the blend),
        "dpmpp_2m" / "dpmpp" (deterministic, `ddim_eta` ignored, no blend) or
        "ddpm" (the ancestral loop over the whole DDPM table; `ddim_steps`,
        eta and spacing ignored; no paste/overlap). paste_cond_frame /
        num_overlap: the conditioning frame / the first frames pasted from
        the clean latents (which are then all encoded). Returns the latents
        with decode=False, and (out, cond) with return_cond.

        x_T / step_noise: optional initial latents and per-step draws in
        place of `generator` (`models/sampler.py`); perturb_noise: the camera
        models' zero-translation perturbation draws (test hooks)."""
        if sampler not in ("ddim", "dpmpp_2m", "dpmpp", "ddpm"):
            raise ValueError(f"unknown sampler {sampler!r} (ddim | dpmpp_2m | ddpm)")
        if sampler == "ddpm" and (paste_cond_frame or num_overlap > 0):
            raise ValueError("paste/overlap surgery requires sampler='ddim'")
        if sampler in ("dpmpp_2m", "dpmpp") and blend_mask is not None:
            raise ValueError("blend_mask/blend_x0 requires sampler='ddim'")
        cfg = self.config
        z, cond = self.prepare_batch(
            batch, None, random_uncond=False, rand_cond_frame=False, cond_frame_index=cond_frame_index,
            enable_camera_condition=enable_camera_condition, trace_scale_factor=trace_scale_factor,
            need_full_z=paste_cond_frame or num_overlap > 0, prefetch_uncond=guidance_scale != 1.0,
            perturb_noise=perturb_noise)
        shape = z.shape
        b = shape[0]
        fs = self.get_fs(batch)
        # one camera geometry serves every step: the epipolar masks can be
        # built once as K6p's penalties (CAMC2V_EPI_PRECOMP)
        cam, epi = cond.get("camera"), getattr(self.config, "epipolar", None)
        if cam is not None and epi is not None and cam.get("epi_prep"):
            cam["epi_prep"] = add_precomputed_penalties(cam["epi_prep"], epi, self.config.video_length)
        uc = (self.build_uncond(cond, b, batch["video"].shape[2:4], negative_prompt_tokens)
              if guidance_scale != 1.0 else None)
        cond.pop("_uncond", None)
        fn = self.build_guided_fn(cond, uc, fs, guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                                  camera_cfg=camera_cfg, camera_cfg_scheduler=camera_cfg_scheduler,
                                  cfg_interval=cfg_interval)
        device = batch["video"].device
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        options = SamplerOptions(parameterization=cfg.parameterization, paste_cond_frame=paste_cond_frame,
                                 num_overlap=num_overlap, clean_cond=clean_cond)
        draws = dict(generator=generator, step_noise=step_noise)
        blend = {} if blend_mask is None else dict(blend_mask=blend_mask, blend_x0=blend_x0)
        if sampler == "ddpm":
            samples = p_sample_loop(self.schedule, x_T, fn, options=options, **blend, **draws)
        else:
            ddim = DDIMSchedule.create(self.schedule, ddim_steps, timestep_spacing, ddim_eta, scale_arr=self.scale_arr)
            surgery = dict(options=options, schedule=self.schedule, origin_z0=cond["origin_z0"],
                           cond_frame_index=cond["c_cond_frame_index"], **draws)
            if sampler == "ddim":
                samples = ddim_sample(ddim, x_T, fn, **surgery, **blend)
            else:
                samples = dpmpp_2m_sample(ddim, x_T, fn, **surgery)
        out = self.decode_first_stage(samples) if decode else samples
        return (out, cond) if return_cond else out


def take_frame(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every sample b of a (B, T, ...) tensor."""
    return x[torch.arange(x.shape[0], device=x.device), idx.to(x.device)]


# the cond entries the UNet reads; the others (origin_z0, c_cond_frame_index,
# the prefetched uncond) are the samplers' or build_uncond's
_MODEL_KEYS = ("c_concat", "c_crossattn", "c_crossattn_mask", "camera")


def _model_inputs(cond: dict) -> dict:
    return {k: v for k, v in cond.items() if k in _MODEL_KEYS}


def _strip_penalties(cond: dict) -> tuple[dict, dict]:
    """(cond without the epipolar penalties, {ds: penalties}): the payload
    to stack for the fused batch, and the batch-shared part kept once."""
    cam = cond.get("camera")
    if not isinstance(cam, dict) or not cam.get("epi_prep"):
        return cond, {}
    prep = cam["epi_prep"]
    shared = {ds: e["penalties"] for ds, e in prep.items() if "penalties" in e}
    strip = {ds: {k: v for k, v in e.items() if k != "penalties"} for ds, e in prep.items()}
    return dict(cond, camera=dict(cam, epi_prep=strip)), shared


def _stack(a: Any, b: Any) -> Any:
    """Concatenate two payloads of the same structure (dicts and tuples of
    tensors) along the batch axis."""
    if isinstance(a, dict):
        return {k: _stack(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_stack(x, y) for x, y in zip(a, b))
    return torch.cat([a, b])
