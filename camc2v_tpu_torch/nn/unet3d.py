"""DynamiCrafter 3D UNet (`camc2v_tpu/nn/unet3d.py`) with the camera hooks.

x is (B, T, h, w, C) latents. Spatial stages run frame-wise on
(B*T, h, w, C), temporal stages on (B, T, h, w, C). The per-frame context
(text tokens broadcast to every frame, image tokens per frame: the
reference's `77 + T*16` split) is assembled once at the top of the forward.
Submodule names follow the JAX parameter tree (`in_{i}_res`, `mid_spatial`,
`out_{i}_up`, ...) so the weight bridge maps them one to one.

With `use_camera` / `epipolar` every temporal transformer except init_attn
(and any level whose width equals init_attn's, the reference's identity
test) gets the camera branch; `forward(..., camera=...)` routes the
Plücker feature pyramid by log2 of the block's latent downsample factor, the
last level to the middle block (reference modified_forwards.py:64-124).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from camc2v_tpu_torch.config import UNetConfig
from camc2v_tpu_torch.core.schedules import timestep_embedding
from camc2v_tpu_torch.nn.attention import SpatialTransformer, TemporalTransformer
from camc2v_tpu_torch.nn.layers import Conv, Downsample, GroupNorm32, ResBlock, TimestepEmbedMLP, Upsample


class UNetModel(nn.Module):
    """(x, timesteps, context, fs) -> eps prediction, (B, T, h, w, C_out) f32."""

    def __init__(self, config: UNetConfig, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        if cfg.resblock_updown:
            raise NotImplementedError("UNetModel: resblock_updown is not ported (off in every shipped config)")
        if cfg.camera_mode != "plucker_epipolar":
            raise NotImplementedError(f"UNetModel: camera_mode '{cfg.camera_mode}' (MotionCtrl, CameraCtrl) "
                                      "is not ported")
        self.dtype = dtype
        ch = cfg.model_channels
        emb_dim = ch * 4
        self.time_embed = TimestepEmbedMLP(ch, emb_dim, dtype=dtype)
        if cfg.fs_condition:
            self.fps_embedding = TimestepEmbedMLP(ch, emb_dim, dtype=dtype)

        def spatial(ch_):
            n_heads, d_head = cfg.heads_for(ch_)
            return SpatialTransformer(
                ch_, n_heads, d_head, depth=cfg.transformer_depth, context_dim=cfg.context_dim,
                image_cross_attention=cfg.image_cross_attention,
                image_cross_attention_scale_learnable=cfg.image_cross_attention_scale_learnable,
                dtype=dtype,
            )

        def temporal(ch_, n_heads=None, d_head=None, with_camera=True):
            if n_heads is None:
                n_heads, d_head = cfg.heads_for(ch_)
            # the reference's camera patch skips temporal blocks as wide as
            # init_attn (8 * num_head_channels); no flagship level is
            if cfg.addition_attention and n_heads * d_head == 8 * cfg.num_head_channels:
                with_camera = False
            return TemporalTransformer(
                ch_, n_heads, d_head, depth=cfg.transformer_depth, only_self_att=cfg.temporal_selfatt_only,
                causal_attention=cfg.use_causal_attention, relative_position=cfg.use_relative_position,
                use_camera=cfg.use_camera and with_camera, epipolar=cfg.epipolar if with_camera else None,
                add_type=cfg.add_type, dtype=dtype,
            )

        def resblock(in_ch, out_ch):
            return ResBlock(in_ch, out_ch, emb_dim, use_scale_shift_norm=cfg.use_scale_shift_norm,
                            use_temporal_conv=cfg.temporal_conv, dtype=dtype)

        self.conv_in = Conv(cfg.in_channels, ch, (3, 3), dtype=dtype)
        if cfg.addition_attention:
            # init_attn: 8 heads x num_head_channels whatever the width
            self.init_attn = temporal(ch, 8, cfg.num_head_channels, with_camera=False)

        # (kind, name) per layer of each block; modules registered by name
        self.input_layout: list[list[tuple[str, str]]] = []
        self.input_ds: list[int] = []  # latent downsample factor of each block
        chans = [ch]
        ds = 1
        blk = 0
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                out_ch = mult * cfg.model_channels
                layers = [self._add("res", f"in_{blk}_res", resblock(ch, out_ch))]
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    layers.append(self._add("spatial", f"in_{blk}_spatial", spatial(ch)))
                    if cfg.temporal_attention:
                        layers.append(self._add("temporal", f"in_{blk}_temporal", temporal(ch)))
                self.input_layout.append(layers)
                self.input_ds.append(ds)
                chans.append(ch)
                blk += 1
            if level != len(cfg.channel_mult) - 1:
                down = Downsample(ch, ch, use_conv=cfg.conv_resample, dtype=dtype)
                self.input_layout.append([self._add("resample", f"in_{blk}_down", down)])
                self.input_ds.append(ds)
                chans.append(ch)
                ds *= 2
                blk += 1

        mid = [self._add("res", "mid_res1", resblock(ch, ch)), self._add("spatial", "mid_spatial", spatial(ch))]
        if cfg.temporal_attention:
            mid.append(self._add("temporal", "mid_temporal", temporal(ch)))
        mid.append(self._add("res", "mid_res2", resblock(ch, ch)))
        self.middle_layout = mid
        self.middle_ds = ds

        self.output_layout: list[list[tuple[str, str]]] = []
        self.output_ds: list[int] = []
        blk = 0
        for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
            for i in range(cfg.num_res_blocks + 1):
                out_ch = cfg.model_channels * mult
                layers = [self._add("res", f"out_{blk}_res", resblock(ch + chans.pop(), out_ch))]
                self.output_ds.append(ds)
                ch = out_ch
                if ds in cfg.attention_resolutions:
                    layers.append(self._add("spatial", f"out_{blk}_spatial", spatial(ch)))
                    if cfg.temporal_attention:
                        layers.append(self._add("temporal", f"out_{blk}_temporal", temporal(ch)))
                if level and i == cfg.num_res_blocks:
                    up = Upsample(ch, ch, use_conv=cfg.conv_resample, dtype=dtype)
                    layers.append(self._add("resample", f"out_{blk}_up", up))
                    ds //= 2
                self.output_layout.append(layers)
                blk += 1

        self.out_norm = GroupNorm32(ch)
        self.out_conv = Conv(ch, cfg.out_channels, (3, 3), dtype=dtype)

    def _add(self, kind: str, name: str, module: nn.Module) -> tuple[str, str]:
        self.add_module(name, module)
        return kind, name

    def _camera_for(self, camera: Optional[dict], ds: int, use_last_plucker: bool = False) -> Optional[dict]:
        """The camera payload of a block at latent downsample `ds`: the
        Plücker pyramid level log2(ds), the last level for the middle block,
        none at a level without attention."""
        if camera is None or camera.get("plucker") is None:
            return camera
        plucker = camera["plucker"]
        if use_last_plucker:
            level = plucker[-1]
        elif ds in self.config.attention_resolutions:
            level = plucker[int(math.log2(ds))]
        else:
            level = None
        return dict(camera, plucker=level)

    def _apply_block(self, layers, h, emb, context, b, context_mask, camera=None):
        for kind, name in layers:
            module = getattr(self, name)
            if kind == "res":
                h = module(h, emb, batch_size=b)
            elif kind == "spatial":
                h = module(h, context=context, context_mask=context_mask)
            elif kind == "temporal":
                n, hh, ww, c = h.shape
                h = module(h.reshape(b, n // b, hh, ww, c), camera=camera).reshape(n, hh, ww, c)
            else:
                h = module(h)
        return h

    def forward(self, x, timesteps, context, fs=None, camera: Optional[dict] = None, *, context_mask=None):
        """x (B, T, h, w, C_in); timesteps (B,); context (B, L, D); fs (B,);
        camera: the camera payload (`plucker` pyramid, `F`, `epi_prep`) or None;
        context_mask: optional (B, L) or (B, T, L) bool token validity."""
        cfg = self.config
        b, t, hh, ww, _ = x.shape
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels).to(self.dtype))

        l_ctx = context.shape[1]
        if l_ctx == cfg.text_context_len + t * cfg.img_tokens_per_frame:
            ctx_text = context[:, None, : cfg.text_context_len].expand(b, t, cfg.text_context_len, -1)
            ctx_img = context[:, cfg.text_context_len:].reshape(b, t, cfg.img_tokens_per_frame, -1)
            context = torch.cat([ctx_text, ctx_img], dim=2).reshape(b * t, -1, context.shape[-1])
            context_mask = None  # single-frame context is never padded
        else:
            context = context.repeat_interleave(t, dim=0)
            if context_mask is not None:
                if context_mask.dim() == 3:
                    context_mask = context_mask.bool().reshape(b * t, l_ctx)
                else:
                    context_mask = context_mask.bool().repeat_interleave(t, dim=0)
        context = context.to(self.dtype)

        emb = emb.repeat_interleave(t, dim=0)
        if cfg.fs_condition:
            if fs is None:
                fs = torch.full((b,), cfg.default_fs, dtype=torch.int32, device=x.device)
            fs_emb = self.fps_embedding(timestep_embedding(fs, cfg.model_channels).to(self.dtype))
            emb = emb + fs_emb.repeat_interleave(t, dim=0)

        h = self.conv_in(x.reshape(b * t, hh, ww, x.shape[-1]).to(self.dtype))
        if cfg.addition_attention:
            h = self.init_attn(h.reshape(b, t, *h.shape[1:])).reshape(b * t, *h.shape[1:])
        hs = [h]
        for layers, ds in zip(self.input_layout, self.input_ds):
            h = self._apply_block(layers, h, emb, context, b, context_mask, self._camera_for(camera, ds))
            hs.append(h)
        h = self._apply_block(self.middle_layout, h, emb, context, b, context_mask,
                              self._camera_for(camera, self.middle_ds, use_last_plucker=True))
        for layers, ds in zip(self.output_layout, self.output_ds):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_block(layers, h, emb, context, b, context_mask, self._camera_for(camera, ds))
        h = self.out_conv(self.out_norm(h, silu=True))
        return h.reshape(b, t, hh, ww, cfg.out_channels).float()
