"""CamContextI2V, the paper's model: camera control plus multi-frame context
(`camc2v_tpu/models/camcontexti2v.py`; reference model/camcontexti2v.py:30-839).

On top of CamI2V:
  * a semantic branch: CLIP + Resampler tokens of the conditioning frame and
    of every context frame, concatenated into c_crossattn ('token_concat');
  * a latent branch: `MultiLatentEpipolarAdaptor` queries attend over the
    [cond ‖ context] VAE latents, masked by the epipolar geometry between
    the target frames and the context cameras, then a zero-initialised
    3x3x3 conv residual onto the repeated cond-frame latent gives c_concat.

The adaptor's mask is computed in K6 from the queries' epipolar lines when
the config is the plain band and its shape allows (one query per latent
pixel, hw >= 256: the flagship), else materialised densely with the
config's variants (`camera/geometry.py::conditional_epipolar_mask`; the
attention seam sends it to K2 on the card).

Generation (only the cond and context frames VAE-encoded) and training
(`need_full_z`: all T + N frames encoded, CFG dropout, the adaptor's
`adaptor_use_mask` phase flag) are ported, at any conditioning frame
(`cond_frame_index`, `rand_cond_frame`). In training the
adaptor runs on K6 and its gradient on K7.

The other strategies and options (JAX `camc2v_tpu/models/camcontexti2v.py`):
  * 'max' / 'avg': no adaptor; the conditioning and context frames' image
    tokens are pooled over the frames (max, or mean) into one frame's
    tokens, padded frames left out by the validity flags. The pooled tokens
    are all valid, so no `c_crossattn_mask` is written (a recorded
    divergence: the JAX package writes one from the pooled length, which
    does not match its c_crossattn);
  * 'token_concat': the semantic branch without the latent one;
  * `use_cross_normalization`: the adaptor's output re-normalised to the
    conditioning latent's mean and (unbiased) std, per channel over (T, h,
    w) ('spatio_temporal') or per sample over tokens and channels
    ('token'), before the zero conv;
  * 'pose_agent_enc' raises, as in JAX: the reference's strategy is a stub
    that crashes on its first batch.

Padded context batches (the data path pads 1-4 context frames to 4 and
writes `cond_frames_valid`, `data/realestate10k.py::RealEstate10K.collate`)
give the unpadded batch's numbers, as in the JAX package: on the adaptor's
kernel path the padded frames' epipolar lines are NaN, so every distance
test fails, their keys are hidden and their tiles skipped (K6, K7), while
the register tokens stay visible; on the dense path their key columns are
cleared; and `c_crossattn_mask` hides their image tokens from the UNet's
image cross-attention (K2, K5).

Batch keys on top of CamI2V's:
  "cond_frames": (B, N, H, W, 3) context frames, "RT_cond": (B, N, 4, 4);
  optional "cond_frames_valid": (B, N) bool, False for a padded slot (zero
  frames, identity poses).
"""

from __future__ import annotations

from typing import Optional

import torch

from camc2v_tpu_torch.camera import geometry as G
from camc2v_tpu_torch.camera.adaptors import MultiLatentEpipolarAdaptor, cross_normalization
from camc2v_tpu_torch.config import CamContextI2VConfig, EpipolarConfig
from camc2v_tpu_torch.models.camera_base import CamI2V
from camc2v_tpu_torch.models.dynamicrafter import take_frame
from camc2v_tpu_torch.nn.epipolar import plain_epipolar
from camc2v_tpu_torch.nn.layers import Conv
from camc2v_tpu_torch.ops import epipolar_flash as ef

_LATENT = ("token_concat_latent", "token_concat_latent_epipolar")


class CamContextI2V(CamI2V):
    def __init__(self, config: CamContextI2VConfig, dtype=torch.bfloat16):
        super().__init__(config, dtype=dtype)
        strategy = config.multi_cond_strategy
        if strategy == "pose_agent_enc":
            raise NotImplementedError("multi_cond_strategy='pose_agent_enc' is a non-functional stub in the "
                                      "reference (crashes there on first use); not rebuilt")
        if config.use_cross_normalization and config.cross_normalization_mode not in ("spatio_temporal", "token"):
            raise ValueError(f"unknown cross_normalization_mode '{config.cross_normalization_mode}'")
        self.adaptor = None
        if strategy in _LATENT:
            a = config.adaptor
            self.adaptor = MultiLatentEpipolarAdaptor(
                query_dim=a.query_dim, depth=a.depth, dim_head=a.dim_head, heads=a.heads,
                num_queries=a.num_queries, embedding_dim=a.embedding_dim, output_dim=a.output_dim,
                ff_mult=a.ff_mult, num_register_tokens=a.num_register_tokens, use_mask=a.use_mask,
                video_length=a.video_length, use_plucker_embedding=a.use_plucker_embedding,
                timestep_embedding_type=a.timestep_embedding_type,
                timestep_embedding_dim=a.timestep_embedding_dim, dtype=dtype,
            )
        self.zero_conv = Conv(4, 4, (3, 3, 3), dtype=dtype) if config.use_zero_conv_latent_input else None

    def _adaptor_kernel_ok(self, hw: int, masking: bool) -> bool:
        """The adaptor's in-kernel mask applies (the JAX rule: the plain band
        at a layout K6 tiles)."""
        cfg: CamContextI2VConfig = self.config
        a = cfg.adaptor
        return (masking and cfg.multi_cond_strategy == "token_concat_latent_epipolar"
                and plain_epipolar(cfg.epipolar or EpipolarConfig()) and a.num_queries == hw and hw >= 256
                and (a.num_queries * a.video_length) % ef.BLOCK_Q == 0 and (hw % ef.BLOCK_K == 0 or hw % 256 == 0))

    def latent_condition(self, batch: dict, z_cond: torch.Tensor, z_add: torch.Tensor,
                         cond_frame_index: torch.Tensor, adaptor_use_mask: Optional[bool] = None,
                         ctx_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, h, w, 4) c_concat of the latent branch from the cond-frame
        latent z_cond (B, h, w, 4) and the context latents z_add (B, N, h, w, 4).
        adaptor_use_mask: the training phase flag (None: the config's);
        ctx_valid: (B, N) bool, False for a padded context slot."""
        cfg: CamContextI2VConfig = self.config
        b, n_ctx, hl, wl, c = z_add.shape
        t, hw = cfg.video_length, hl * wl
        z_tokens = torch.cat([z_cond[:, None], z_add], dim=1).reshape(b, (1 + n_ctx) * hw, c)
        args = (batch["camera_intrinsics"], batch["RT"], batch["RT_cond"], cond_frame_index)
        masking = cfg.adaptor.use_mask if adaptor_use_mask is None else adaptor_use_mask
        # (B, 1 + N) validity of the key frames: the cond frame always
        frame_valid = None if ctx_valid is None else torch.cat(
            [torch.ones(b, 1, dtype=torch.bool, device=ctx_valid.device), ctx_valid], dim=1)
        if self._adaptor_kernel_ok(hw, masking):
            blk = ef.BLOCK_K if hw % ef.BLOCK_K == 0 else hw
            lines = ef.epipolar_lines(G.conditional_fundamental(*args), hl, wl, 8)
            if frame_valid is not None:  # NaN lines hide a padded frame's keys and empty its tiles
                lines = torch.where(frame_valid[:, None, :, None], lines, torch.nan)
            tiles = ef.kernel_tile_map(lines, 1 + n_ctx, hl, wl, 8)
            img_cat = self.adaptor(z_tokens, use_mask=True, lines=lines, geom=(1 + n_ctx, hl, wl, 8, blk),
                                   tile_any=tiles)
        else:
            mask = None
            if cfg.multi_cond_strategy == "token_concat_latent_epipolar" and cfg.adaptor.use_mask:
                H, W = batch["video"].shape[2:4]
                mask = G.conditional_epipolar_mask(*args, H, W, downsample=8,
                                                   config=cfg.epipolar or EpipolarConfig())
            use_mask = adaptor_use_mask
            if frame_valid is not None:
                # validity columns: a padded frame's keys are never visible (a
                # mask-freeze phase drops the epipolar part only)
                token_valid = frame_valid.repeat_interleave(hw, dim=1)  # (B, (1 + N) * hw)
                lq = cfg.adaptor.num_queries * cfg.adaptor.video_length
                base = mask if masking and mask is not None else torch.ones(
                    b, lq, z_tokens.shape[1], dtype=torch.bool, device=z_tokens.device)
                mask, use_mask = base & token_valid[:, None, :], True
            img_cat = self.adaptor(z_tokens, mask, use_mask=use_mask)
        if cfg.use_cross_normalization and cfg.cross_normalization_mode == "spatio_temporal":
            img_cat = cross_normalization(img_cat.reshape(b, t, hl, wl, -1), z_cond[:, None], axes=(-4, -3, -2))
        elif cfg.use_cross_normalization:
            img_cat = cross_normalization(img_cat[:, None], z_cond.reshape(b, 1, hw, -1), axes=(-2, -1))[:, 0]
        img_cat = img_cat.reshape(b, t, hl, wl, -1)
        if self.zero_conv is not None:
            img_cat = z_cond[:, None] + self.zero_conv(img_cat)
        return img_cat

    def _pool_frames(self, img_emb: torch.Tensor, ctx_valid: Optional[torch.Tensor]) -> torch.Tensor:
        """(B, 1 + N, L, D) image tokens -> (B, L, D): their max or mean over
        the frames, a padded context frame (ctx_valid False) left out."""
        if ctx_valid is None:
            return img_emb.amax(dim=1) if self.config.multi_cond_strategy == "max" else img_emb.mean(dim=1)
        b = img_emb.shape[0]
        fv = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=ctx_valid.device), ctx_valid], dim=1)
        fv = fv.to(img_emb.device)[:, :, None, None]
        if self.config.multi_cond_strategy == "max":
            return torch.where(fv, img_emb, -torch.inf).amax(dim=1)
        return torch.where(fv, img_emb, 0.0).sum(dim=1) / fv.to(img_emb.dtype).sum(dim=1)

    def prepare_batch(self, batch: dict, generator: Optional[torch.Generator] = None, *,
                      random_uncond: bool = False, rand_cond_frame: Optional[bool] = None,
                      cond_frame_index=None, enable_camera_condition: bool = True,
                      trace_scale_factor: float = 1.0, need_full_z: bool = False, prefetch_uncond: bool = False,
                      perturb_noise: Optional[torch.Tensor] = None, adaptor_use_mask: Optional[bool] = None):
        """(z, cond) (reference camcontexti2v.py:280-491); the flags as in
        `DynamiCrafter.prepare_batch`. need_full_z encodes the T target
        frames and the N context frames in one VAE call; otherwise the
        conditioning frame and the context frames. The latent branch always
        runs on the cameras (`enable_camera_condition` leaves out only the
        UNet's camera payload, as in the JAX package)."""
        cfg: CamContextI2VConfig = self.config
        video, cond_frames = batch["video"], batch.get("cond_frames")
        ctx_valid = batch.get("cond_frames_valid")
        ctx_valid = None if ctx_valid is None or cond_frames is None else ctx_valid.bool()
        b, t, H, W = video.shape[:4]
        idx = self.cond_frame_indices(b, video.device, generator, rand_cond_frame, cond_frame_index)
        camera = (self.camera_condition(batch, idx, trace_scale_factor=trace_scale_factor,
                                        perturb_noise=perturb_noise) if enable_camera_condition else None)

        img = take_frame(video, idx)
        latent = cond_frames is not None and self.adaptor is not None
        if need_full_z:
            z_all = self.encode_first_stage(torch.cat([video, cond_frames], dim=1) if latent else video, generator)
            z, z_add = z_all[:, :t], z_all[:, t:]
            z_cond = take_frame(z, idx)
        else:
            frames = torch.cat([img[:, None], cond_frames], dim=1) if latent else img[:, None]
            z_sel = self.encode_first_stage(frames, generator)  # (B, 1[+N], h, w, 4)
            z_cond, z_add = z_sel[:, 0], z_sel[:, 1:]
            z = z_cond[:, None].expand(b, t, *z_cond.shape[1:])
        if latent:
            c_concat = self.latent_condition(batch, z_cond, z_add, idx, adaptor_use_mask, ctx_valid)
        else:
            c_concat = z_cond[:, None].expand(b, t, *z_cond.shape[1:])

        prompt_emb, null_prompt, input_mask = self._text_condition(batch, b, generator, random_uncond, video.device)
        if cfg.use_semantic_branch and cond_frames is not None:
            n_ctx = cond_frames.shape[1]
            imgs = input_mask[:, None] * torch.cat([img[:, None], cond_frames], dim=1)
            imgs = imgs.reshape(b * (1 + n_ctx), H, W, 3)
        else:
            n_ctx = 0
            imgs = input_mask * img
        cond = {}
        if prefetch_uncond:
            emb_all = self.embed_images(torch.cat([imgs, torch.zeros_like(imgs[:1])]))
            img_emb, uc_img = emb_all[:-1], emb_all[-1:]
            cond["_uncond"] = {"img_emb": uc_img.expand(b, -1, -1), "prompt_emb": null_prompt.expand(b, -1, -1)}
        else:
            img_emb = self.embed_images(imgs)
        l_tok = img_emb.shape[1]
        img_emb = img_emb.reshape(b, 1 + n_ctx, l_tok, -1)
        pooled = cfg.multi_cond_strategy in ("max", "avg") and n_ctx > 0
        if pooled:
            img_emb = self._pool_frames(img_emb, ctx_valid)
        else:
            img_emb = img_emb.reshape(b, (1 + n_ctx) * l_tok, -1)
        cond["c_concat"] = c_concat
        cond["c_cond_frame_index"] = idx
        cond["origin_z0"] = z if need_full_z else None
        cond["c_crossattn"] = torch.cat([prompt_emb, img_emb], dim=1)
        if ctx_valid is not None and n_ctx and not pooled:
            # token validity of the UNet's image cross-attention: a padded frame's tokens hidden
            frame_valid = torch.cat([torch.ones(b, 1, dtype=torch.bool, device=video.device), ctx_valid], dim=1)
            cond["c_crossattn_mask"] = torch.cat([
                torch.ones(b, prompt_emb.shape[1], dtype=torch.bool, device=video.device),
                frame_valid.repeat_interleave(l_tok, dim=1)], dim=1)
        if camera is not None:
            cond["camera"] = camera
        return z, cond
