"""Static model configurations of the port.

Same field names and defaults as the JAX package's dataclasses
(`camc2v_tpu/nn/unet3d.py::UNetConfig`, `nn/vae.py::VAEConfig`,
`nn/clip.py::CLIPTextConfig`/`CLIPVisionConfig`,
`models/dynamicrafter.py::ResamplerConfig`/`DynamiCrafterConfig`), defined
here again because the port may not import the JAX package. UNetConfig omits
the camera fields (`use_camera`, `epipolar`, `add_type`, `camera_mode`,
`pose_dim`) and the JAX remat knobs (`remat`, `remat_policy`): the port has
no camera branch yet and runs inference only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: tuple[int, ...] = (4, 2, 1)
    dropout: float = 0.0
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    conv_resample: bool = True
    context_dim: Optional[int] = 1024
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    num_heads: int = -1
    num_head_channels: int = 64
    transformer_depth: int = 1
    temporal_conv: bool = True
    tempspatial_aware: bool = False
    temporal_attention: bool = True
    temporal_selfatt_only: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    temporal_length: int = 16
    addition_attention: bool = True
    image_cross_attention: bool = True
    image_cross_attention_scale_learnable: bool = False
    default_fs: int = 3
    fs_condition: bool = True
    text_context_len: int = 77
    img_tokens_per_frame: int = 16

    def heads_for(self, ch: int) -> tuple[int, int]:
        if self.num_head_channels == -1:
            return self.num_heads, ch // self.num_heads
        return ch // self.num_head_channels, self.num_head_channels


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    double_z: bool = True
    z_channels: int = 4
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = ()
    dropout: float = 0.0
    embed_dim: int = 4


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 1024
    heads: int = 16
    layers: int = 24
    output_layer: str = "penultimate"  # or "last"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    heads: int = 16
    layers: int = 32


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: Optional[int] = 16
    use_timestep_emb: bool = True


@dataclasses.dataclass(frozen=True)
class DynamiCrafterConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    clip_text: CLIPTextConfig = CLIPTextConfig()
    clip_vision: CLIPVisionConfig = CLIPVisionConfig()
    resampler: ResamplerConfig = ResamplerConfig()
    # diffusion
    timesteps: int = 1000
    beta_schedule: str = "linear"
    linear_start: float = 0.00085
    linear_end: float = 0.012
    rescale_betas_zero_snr: bool = False
    parameterization: str = "eps"
    scale_factor: float = 0.18215
    loss_type: str = "l2"
    noise_strength: float = 0.0
    use_dynamic_rescale: bool = False
    base_scale: float = 0.7
    turning_step: int = 400
    # conditioning
    uncond_prob: float = 0.05
    uncond_type: str = "empty_seq"
    rand_cond_frame: bool = False
    fps_condition_type: str = "fs"
    interp_mode: bool = False
    perframe_ae: bool = False

    @property
    def video_length(self) -> int:
        return self.unet.temporal_length

    @property
    def latent_channels(self) -> int:
        return self.unet.out_channels
