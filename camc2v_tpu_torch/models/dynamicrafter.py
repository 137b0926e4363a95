"""DynamiCrafter image-to-video model (`camc2v_tpu/models/dynamicrafter.py`).

One `nn.Module` owns the UNet, the VAE, the CLIP text and vision towers and
the Resampler; methods mirror the JAX assembly's generation path:
`prepare_batch` -> `build_uncond` -> `build_guided_fn` -> `ddim_sample` (or
`dpmpp_2m_sample`) -> `decode_first_stage`, driven by `sample`; and its
training loss:
`prepare_batch(random_uncond=True, need_full_z=True)` -> `p_losses`
(q_sample, the UNet with `deterministic=False`, `get_loss`), driven by
`training_loss`. The random draws of the loss (VAE posterior sample, CFG
dropout, timestep, noise) come from the `generator` the caller passes, the
JAX rng's counterpart; the UNet's dropout draws from the global RNG.
The VAE encoder and the CLIP towers are frozen and take data: they run under
`torch.no_grad()` (the JAX `stop_gradient` on the text embedding).

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

from camc2v_tpu_torch import ops
from camc2v_tpu_torch.config import DynamiCrafterConfig
from camc2v_tpu_torch.core import distributions as D
from camc2v_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule, q_sample, rescale_noise_cfg
from camc2v_tpu_torch.models.sampler import ddim_sample, dpmpp_2m_sample
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
    @torch.no_grad()
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

    def prepare_batch(self, batch: dict, generator: Optional[torch.Generator] = None, *,
                      random_uncond: bool = False, need_full_z: bool = False, prefetch_uncond: bool = False,
                      perturb_noise: Optional[torch.Tensor] = None):
        """(z, cond), cond frame 0 (reference model/base.py:237-344).

        generator: the VAE posterior is sampled with it (its mode without
        one) and, with `random_uncond`, the CFG dropout draws from it.
        need_full_z: every frame is VAE-encoded and z holds the clean latents
        (training); otherwise only the conditioning frame is encoded and z is
        a broadcast view of it carrying the latent shape (generation)."""
        video = batch["video"]
        b, t = video.shape[:2]
        img = video[:, 0]  # cond_frame_index 0
        if need_full_z:
            z = self.encode_first_stage(video, generator)
            z_cond = z[:, 0]
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
        cond["c_concat"] = z_cond[:, None].expand(b, t, *z_cond.shape[1:])
        cond["c_crossattn"] = torch.cat([prompt_emb, img_emb], dim=1)
        cond_frame_index = torch.zeros(b, dtype=torch.long, device=video.device)
        camera = self.camera_condition(batch, cond_frame_index, perturb_noise=perturb_noise)
        if camera is not None:
            cond["camera"] = camera
        return z, cond

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
        """The eps-prediction loss at timesteps t with the given noise
        (reference ddpm3d.py:741-785): (loss, {"loss_simple", "loss"})."""
        x_noisy = q_sample(self.schedule, z, t, noise)
        model_output = self.apply_model(x_noisy, t, cond, fs, deterministic=deterministic)
        # the schedule takes eps only (DiffusionSchedule.create raises on the others)
        loss_simple = self.get_loss(model_output, noise).mean(dim=(1, 2, 3, 4))
        loss = loss_simple.mean()
        return loss, {"loss_simple": loss_simple.mean().detach(), "loss": loss.detach()}

    def training_loss(self, batch: dict, generator: torch.Generator, *, deterministic: bool = False,
                      **prepare_kwargs) -> tuple[torch.Tensor, dict]:
        """The train-step loss (reference shared_step, camcontexti2v.py:779-793):
        conditioning with CFG dropout and every frame encoded, a uniform
        timestep and standard-normal noise per sample (plus the offset noise
        of `noise_strength`), the UNet in training mode (`deterministic=True`:
        dropout and block remat off, the validation loss). `prepare_kwargs`
        carries per-phase flags (CamContextI2V's `adaptor_use_mask`)."""
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
                        guidance_rescale: float = 0.0):
        """Guided denoiser closure. When the cond and uncond contexts have one
        shape, both run as ONE batch-2B UNet call, everything stacked but the
        epipolar penalties, which the uncond shares with cond (K6p reads the
        (B, ...) copy for the 2B batch); otherwise (CamContextI2V's
        multi-frame context against a single-frame uncond) two calls, or with
        `CAMC2V_FUSED_CFG=1` the uncond padded to cond's length
        (`_pad_uncond_for_fusion`) and one call."""
        if uc is None or guidance_scale == 1.0:
            return lambda x, t: self.apply_model(x, t, cond, fs)
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
               ddim_eta: float = 1.0, sampler: str = "ddim", guidance_scale: float = 7.5,
               guidance_rescale: float = 0.0, timestep_spacing: str = "uniform", decode: bool = True,
               camera_cfg: float = 1.0, x_T: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None, perturb_noise: Optional[torch.Tensor] = None):
        """CFG sampling -> decoded video (B, T, H, W, 3), with the JAX
        package's keyword defaults. sampler: "ddim" (eta noise from
        `generator` or `step_noise`) or "dpmpp_2m" (deterministic,
        `ddim_eta` ignored) over the DDIM timestep table.

        x_T / step_noise: optional initial latents and per-step standard-normal
        draws in place of `generator`; perturb_noise: the camera models'
        zero-translation perturbation draws (test hooks)."""
        if camera_cfg != 1.0:
            raise NotImplementedError("sample: camera_cfg != 1.0 (the camera-free third pass) is not ported")
        if sampler == "ddpm":
            raise NotImplementedError("sample: the ancestral 'ddpm' loop is not ported")
        if sampler not in ("ddim", "dpmpp_2m"):
            raise ValueError(f"unknown sampler {sampler!r} (ddim | dpmpp_2m | ddpm)")
        z, cond = self.prepare_batch(batch, prefetch_uncond=guidance_scale != 1.0, perturb_noise=perturb_noise)
        shape = z.shape
        b = shape[0]
        fs = self.get_fs(batch)
        # one camera geometry serves every step: the epipolar masks can be
        # built once as K6p's penalties (CAMC2V_EPI_PRECOMP)
        cam, epi = cond.get("camera"), getattr(self.config, "epipolar", None)
        if cam is not None and epi is not None and cam.get("epi_prep"):
            cam["epi_prep"] = add_precomputed_penalties(cam["epi_prep"], epi, self.config.video_length)
        uc = self.build_uncond(cond, b, batch["video"].shape[2:4]) if guidance_scale != 1.0 else None
        cond.pop("_uncond", None)
        fn = self.build_guided_fn(cond, uc, fs, guidance_scale=guidance_scale,
                                  guidance_rescale=guidance_rescale)
        ddim = DDIMSchedule.create(self.schedule, ddim_steps, timestep_spacing, ddim_eta)
        device = batch["video"].device
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        if sampler == "ddim":
            samples = ddim_sample(ddim, x_T, fn, generator=generator, step_noise=step_noise)
        else:
            samples = dpmpp_2m_sample(ddim, x_T, fn)
        return self.decode_first_stage(samples) if decode else samples


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
