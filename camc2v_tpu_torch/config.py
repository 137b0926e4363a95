"""Static model configurations of the port.

Same field names and defaults as the JAX package's dataclasses
(`camc2v_tpu/nn/unet3d.py::UNetConfig`, `nn/vae.py::VAEConfig`,
`nn/clip.py::CLIPTextConfig`/`CLIPVisionConfig`,
`models/dynamicrafter.py::ResamplerConfig`/`DynamiCrafterConfig`,
`nn/epipolar.py::EpipolarConfig`, `camera/pose_encoder.py::PoseEncoderConfig`,
`models/camera_base.py::CameraControlConfig`/`MotionCtrlConfig`/`CamI2VConfig`,
`models/camcontexti2v.py::AdaptorConfig`/`CamContextI2VConfig`), defined
here again because the port may not import the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class EpipolarConfig:
    """Epipolar attention (hashable). Soft masks raise where the masks are
    built, as in JAX; every other field is ported."""

    origin_h: int = 256
    origin_w: int = 256
    is_3d_full_attn: bool = False
    num_register_tokens: int = 0
    compression_factor: int = 1
    only_on_cond_frame: bool = False
    attention_resolution: tuple[int, ...] = (8, 4, 2, 1)
    apply_epipolar_soft_mask: bool = False
    soft_mask_temperature: float = 1.0
    epipolar_hybrid_attention: bool = False
    epipolar_hybrid_attention_v2: bool = False
    only_self_pixel_on_current_frame: bool = False
    current_frame_as_register_token: bool = False
    add_small_perturbation_on_zero_T: bool = False
    pluker_add_type: str = "add_to_pre_x_only"


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
    # camera branch of the temporal blocks: CamI2V / CamContextI2V
    # (use_camera, epipolar, add_type) or the baselines' camera_mode
    use_camera: bool = False
    epipolar: Optional[EpipolarConfig] = None
    add_type: str = "add_to_main_branch"
    camera_mode: str = "plucker_epipolar"
    pose_dim: int = 12
    # training only: rematerialise each UNet block in the backward
    # (torch.utils.checkpoint), saving what the policy names inside it
    # (none | dots | dots_batch | pallas | dots_pallas, `nn/unet3d.py`)
    remat: bool = True
    remat_policy: Optional[str] = None

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


@dataclasses.dataclass(frozen=True)
class PoseEncoderConfig:
    downscale_factor: int = 8
    channels: tuple[int, ...] = (320, 640, 1280, 1280)
    nums_rb: int = 2
    cin: int = 384  # 6 plucker channels * 8 * 8
    ksize: int = 1
    sk: bool = True
    use_conv: bool = False
    compression_factor: int = 1
    temporal_attention_nhead: int = 8
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 16


@dataclasses.dataclass(frozen=True)
class CameraControlConfig(DynamiCrafterConfig):
    pose_encoder: Optional[PoseEncoderConfig] = None
    normalize_T0: bool = False
    camera_embedding: str = "plucker"  # or "ray"


@dataclasses.dataclass(frozen=True)
class MotionCtrlConfig(CameraControlConfig):
    """MotionCtrl's configuration (its UNet has `camera_mode='motionctrl'`)."""

    pose_dim: int = 12


@dataclasses.dataclass(frozen=True)
class CamI2VConfig(CameraControlConfig):
    epipolar: Optional[EpipolarConfig] = EpipolarConfig()
    add_type: str = "add_into_temporal_attn"


@dataclasses.dataclass(frozen=True)
class AdaptorConfig:
    query_dim: int = 512
    num_queries: int = 1024
    video_length: int = 16
    embedding_dim: int = 4
    output_dim: int = 4
    depth: int = 12
    dim_head: int = 64
    heads: int = 8
    ff_mult: int = 4
    num_register_tokens: int = 2
    use_mask: bool = True
    timestep_embedding_type: str = "sinusoidal_embedded"
    timestep_embedding_dim: int = 32
    use_plucker_embedding: bool = False


@dataclasses.dataclass(frozen=True)
class CamContextI2VConfig(CamI2VConfig):
    multi_cond_strategy: Optional[str] = "token_concat_latent_epipolar"
    adaptor: AdaptorConfig = AdaptorConfig()
    use_cross_normalization: bool = False
    cross_normalization_mode: str = "spatio_temporal"  # or "token"
    use_zero_conv_latent_input: bool = True
    use_semantic_branch: bool = True
    epipolar_mask_freeze_steps: Optional[int] = None
    add_type: str = "add_to_main_branch"
