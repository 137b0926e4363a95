"""Production-size presets of the port (values of `camc2v_tpu/presets.py`).

reference: configs/models/camcontexti2v_256.yaml and
configs/baseline/dynamicrafter_256.yaml. Only DynamiCrafter-256 is ported so
far; the camera families follow with their modules.
"""

from __future__ import annotations

from camc2v_tpu_torch.config import (
    CLIPTextConfig,
    CLIPVisionConfig,
    DynamiCrafterConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)


def unet_256(**overrides) -> UNetConfig:
    """reference: configs/models/camcontexti2v_256.yaml:40-72."""
    base = dict(
        in_channels=8,
        out_channels=4,
        model_channels=320,
        num_res_blocks=2,
        attention_resolutions=(4, 2, 1),
        dropout=0.1,
        channel_mult=(1, 2, 4, 4),
        num_head_channels=64,
        transformer_depth=1,
        context_dim=1024,
        temporal_conv=True,
        temporal_attention=True,
        temporal_selfatt_only=True,
        use_relative_position=False,
        use_causal_attention=False,
        temporal_length=16,
        addition_attention=True,
        image_cross_attention=True,
        image_cross_attention_scale_learnable=True,
        default_fs=3,
        fs_condition=True,
    )
    base.update(overrides)
    return UNetConfig(**base)


VAE_256 = VAEConfig(
    double_z=True, z_channels=4, resolution=256, in_channels=3, out_ch=3,
    ch=128, ch_mult=(1, 2, 4, 4), num_res_blocks=2, embed_dim=4,
)

RESAMPLER_256 = ResamplerConfig(
    dim=1024, depth=4, dim_head=64, heads=12, num_queries=16,
    embedding_dim=1280, output_dim=1024, ff_mult=4, video_length=16,
    use_timestep_emb=True,
)

_DIFFUSION_256 = dict(
    timesteps=1000,
    beta_schedule="linear",
    linear_start=0.00085,
    linear_end=0.012,
    rescale_betas_zero_snr=False,
    parameterization="eps",
    scale_factor=0.18215,
    uncond_prob=0.05,
    uncond_type="empty_seq",
    rand_cond_frame=False,
    fps_condition_type="fs",
    vae=VAE_256,
    clip_text=CLIPTextConfig(),
    clip_vision=CLIPVisionConfig(),
    resampler=RESAMPLER_256,
)


def dynamicrafter_256() -> DynamiCrafterConfig:
    return DynamiCrafterConfig(unet=unet_256(), loss_type="l2", **_DIFFUSION_256)


PRESETS = {"dynamicrafter_256": dynamicrafter_256}
