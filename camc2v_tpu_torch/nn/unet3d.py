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
The baselines' `camera_mode` ('motionctrl', 'cameractrl') gives every
temporal transformer its `cc_projection` (the identity test clears only
`use_camera` / `epipolar`, as in JAX), and init_attn too for MotionCtrl,
whose init_attn gets the whole payload (reference
motionctrl_modified_modules.py:69).

Training (`deterministic=False`, as in JAX): the ResBlocks drop out
(`UNetConfig.dropout`, 0.1 in the flagship) and, with `remat`, every
res/spatial/temporal layer of every input, middle and output block runs
under `torch.utils.checkpoint` (non-reentrant), the JAX per-layer `nn.remat`;
conv_in, init_attn, the resamplers and the output head are not
rematerialised, as in JAX. What the checkpoint saves inside a layer is the
remat policy (`remat_policy`: the config's `remat_policy`, overridden by
the environment's `CAMC2V_REMAT_POLICY`, read at each call, as the JAX
`_remat_policy`):
  * `none` (or None): nothing; the backward re-runs every layer's forward,
    kernel forwards included;
  * `dots`: the outputs of `aten.mm` and `aten.addmm` (the JAX
    `dots_with_no_batch_dims_saveable`: the projections and feed-forwards
    that do not run in a kernel);
  * `dots_batch`: those and `aten.bmm` / `aten.baddbmm` (`dots_saveable`);
  * `pallas`: the outputs of every kernel forward with a gradient (K1, K2
    with its logsumexp, K3, K4, K6 / K6p with theirs, K8, K9), which run as
    the dispatcher op `camc2v::kernel_forward` (`ops.saved_forward`), so no
    kernel forward re-runs in the backward; on the CPU the same op carries
    the plain twins' forwards;
  * `dots_pallas`: the union of `dots` and `pallas`.
The policies other than `none` run `create_selective_checkpoint_contexts`
with that list of ops. K1, K3, K4, K8 and K9's backward re-runs their f32
twin to form the vector-Jacobian product (`ops.recompute_grad`) under every
policy: a policy saves forwards, not that recompute. The checkpoint replays
the global RNG state (`preserve_rng_state`), so the recompute draws the same
dropout masks. The transformers, the epipolar attention and the adaptor have
dropout 0 in every config, so the port gives them no dropout and no flag.

`resblock_updown` puts ResBlocks with `down` / `up` (no temporal conv) in
place of the Downsample / Upsample layers, under the same names
(`in_{i}_down`, `out_{i}_up`), as JAX does.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from camc2v_tpu_torch import ops  # noqa: F401  (registers the camc2v::kernel_forward op)

from camc2v_tpu_torch.config import UNetConfig
from camc2v_tpu_torch.core.schedules import timestep_embedding
from camc2v_tpu_torch.nn.attention import SpatialTransformer, TemporalTransformer
from camc2v_tpu_torch.nn.layers import Conv, Downsample, GroupNorm32, ResBlock, TimestepEmbedMLP, Upsample


_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
_KERNELS = (torch.ops.camc2v.kernel_forward.default,)
REMAT_POLICIES = {"dots": _DOTS, "dots_batch": _DOTS + _BATCH_DOTS, "pallas": _KERNELS,
                  "dots_pallas": _DOTS + _KERNELS}


def remat_policy(name: Optional[str]) -> Optional[tuple]:
    """The ops whose outputs a block's checkpoint saves under the policy
    `name` (the environment's CAMC2V_REMAT_POLICY wins over it), or None:
    save nothing (the module docstring; the JAX `_remat_policy`)."""
    name = os.environ.get("CAMC2V_REMAT_POLICY", name or "none")
    if name in (None, "", "none"):
        return None
    if name not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r} (none | dots | dots_batch | pallas | dots_pallas)")
    return REMAT_POLICIES[name]


class UNetModel(nn.Module):
    """(x, timesteps, context, fs) -> eps prediction, (B, T, h, w, C_out) f32."""

    def __init__(self, config: UNetConfig, dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        remat_policy(cfg.remat_policy)  # an unknown name raises where the model is built
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

        def temporal(ch_, n_heads=None, d_head=None, with_camera=True, camera_mode=cfg.camera_mode,
                     causal=cfg.use_causal_attention):
            if n_heads is None:
                n_heads, d_head = cfg.heads_for(ch_)
            # the reference's camera patch skips temporal blocks as wide as
            # init_attn (8 * num_head_channels); no flagship level is
            if cfg.addition_attention and n_heads * d_head == 8 * cfg.num_head_channels:
                with_camera = False
            return TemporalTransformer(
                ch_, n_heads, d_head, depth=cfg.transformer_depth, only_self_att=cfg.temporal_selfatt_only,
                context_dim=cfg.context_dim, causal_attention=causal, relative_position=cfg.use_relative_position,
                temporal_length=cfg.temporal_length, use_camera=cfg.use_camera and with_camera,
                epipolar=cfg.epipolar if with_camera else None, add_type=cfg.add_type, camera_mode=camera_mode,
                pose_dim=cfg.pose_dim, dtype=dtype,
            )

        def resblock(in_ch, out_ch, up=False, down=False):
            return ResBlock(in_ch, out_ch, emb_dim, dropout=cfg.dropout,
                            use_scale_shift_norm=cfg.use_scale_shift_norm,
                            use_temporal_conv=cfg.temporal_conv and not (up or down), up=up, down=down,
                            dtype=dtype)

        self.conv_in = Conv(cfg.in_channels, ch, (3, 3), dtype=dtype)
        if cfg.addition_attention:
            # init_attn: 8 heads x num_head_channels whatever the width, never
            # causal; only MotionCtrl's sees the camera
            self.init_attn = temporal(ch, 8, cfg.num_head_channels, with_camera=False,
                                      camera_mode="motionctrl" if cfg.camera_mode == "motionctrl" else
                                      "plucker_epipolar", causal=False)

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
                if cfg.resblock_updown:
                    layer = self._add("res", f"in_{blk}_down", resblock(ch, ch, down=True))
                else:
                    layer = self._add("resample", f"in_{blk}_down",
                                      Downsample(ch, ch, use_conv=cfg.conv_resample, dtype=dtype))
                self.input_layout.append([layer])
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
                    if cfg.resblock_updown:
                        layers.append(self._add("res", f"out_{blk}_up", resblock(ch, ch, up=True)))
                    else:
                        layers.append(self._add("resample", f"out_{blk}_up",
                                                Upsample(ch, ch, use_conv=cfg.conv_resample, dtype=dtype)))
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

    def _apply_block(self, layers, h, emb, context, b, context_mask, camera=None, deterministic=True):
        remat = self.config.remat and not deterministic
        saved = remat_policy(self.config.remat_policy) if remat else None

        def run(module, *args, **kwargs):
            if not remat:
                return module(*args, **kwargs)
            if saved is None:
                return checkpoint(module, *args, use_reentrant=False, **kwargs)
            return checkpoint(module, *args, use_reentrant=False,
                              context_fn=functools.partial(create_selective_checkpoint_contexts, list(saved)),
                              **kwargs)

        for kind, name in layers:
            module = getattr(self, name)
            if kind == "res":
                h = run(module, h, emb, batch_size=b, deterministic=deterministic)
            elif kind == "spatial":
                h = run(module, h, context=context, context_mask=context_mask)
            elif kind == "temporal":
                n, hh, ww, c = h.shape
                tctx = None if module.only_self_att else context
                h = run(module, h.reshape(b, n // b, hh, ww, c), context=tctx, camera=camera).reshape(n, hh, ww, c)
            else:
                h = module(h)
        return h

    def forward(self, x, timesteps, context, fs=None, camera: Optional[dict] = None, *, context_mask=None,
                deterministic: bool = True):
        """x (B, T, h, w, C_in); timesteps (B,); context (B, L, D); fs (B,);
        camera: the camera payload (`plucker` pyramid, `F`, `epi_prep`; MotionCtrl's
        `RT`) or None;
        context_mask: optional (B, L) or (B, T, L) bool token validity;
        deterministic=False: training (dropout, block remat)."""
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
            init_cam = camera if cfg.camera_mode == "motionctrl" else None
            ictx = None if self.init_attn.only_self_att else context
            h = self.init_attn(h.reshape(b, t, *h.shape[1:]), context=ictx, camera=init_cam).reshape(
                b * t, *h.shape[1:])
        hs = [h]
        for layers, ds in zip(self.input_layout, self.input_ds):
            h = self._apply_block(layers, h, emb, context, b, context_mask, self._camera_for(camera, ds),
                                  deterministic)
            hs.append(h)
        h = self._apply_block(self.middle_layout, h, emb, context, b, context_mask,
                              self._camera_for(camera, self.middle_ds, use_last_plucker=True), deterministic)
        for layers, ds in zip(self.output_layout, self.output_ds):
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._apply_block(layers, h, emb, context, b, context_mask, self._camera_for(camera, ds),
                                  deterministic)
        h = self.out_conv(self.out_norm(h, silu=True))
        return h.reshape(b, t, hh, ww, cfg.out_channels).float()
