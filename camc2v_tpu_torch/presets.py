"""Production-size presets of the port (values of `camc2v_tpu/presets.py`),
the flagship's training recipe, and the entry points that make a model on a
device: `build` (generation) and `build_for_training`.

reference: configs/models/camcontexti2v_256.yaml and
configs/baseline/{dynamicrafter,cami2v}_256.yaml. DynamiCrafter-256, CamI2V-256
and CamContextI2V-256 (the paper's model) are ported; MotionCtrl and
CameraCtrl are not.

    model = build("camcontexti2v_256")  # bf16 on cuda, seeded random weights
    model = build_for_training("camcontexti2v_256")  # fp32, train mode
"""

from __future__ import annotations

import torch

from camc2v_tpu_torch.config import (
    AdaptorConfig,
    CamContextI2VConfig,
    CamI2VConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    DynamiCrafterConfig,
    EpipolarConfig,
    PoseEncoderConfig,
    ResamplerConfig,
    UNetConfig,
    VAEConfig,
)
from camc2v_tpu_torch.parallel.trainer import TrainConfig


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

POSE_ENCODER_256 = PoseEncoderConfig(
    downscale_factor=8, channels=(320, 640, 1280, 1280), nums_rb=2, cin=384,
    ksize=1, sk=True, use_conv=False, compression_factor=1,
    temporal_attention_nhead=8, temporal_position_encoding=True,
    temporal_position_encoding_max_len=16,
)

EPIPOLAR_256 = EpipolarConfig(
    origin_h=256, origin_w=256, is_3d_full_attn=False, num_register_tokens=4,
    attention_resolution=(8, 4, 2, 1), compression_factor=1,
    add_small_perturbation_on_zero_T=True,
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


def cami2v_256() -> CamI2VConfig:
    return CamI2VConfig(
        unet=unet_256(use_camera=True, epipolar=EPIPOLAR_256, add_type="add_into_temporal_attn"),
        pose_encoder=POSE_ENCODER_256,
        epipolar=EPIPOLAR_256,
        add_type="add_into_temporal_attn",
        loss_type="l2",
        **_DIFFUSION_256,
    )


def camcontexti2v_256() -> CamContextI2VConfig:
    """reference: configs/models/camcontexti2v_256.yaml (the paper's model)."""
    return CamContextI2VConfig(
        unet=unet_256(use_camera=True, epipolar=EPIPOLAR_256, add_type="add_to_main_branch"),
        pose_encoder=POSE_ENCODER_256,
        epipolar=EPIPOLAR_256,
        add_type="add_to_main_branch",
        multi_cond_strategy="token_concat_latent_epipolar",
        adaptor=AdaptorConfig(
            query_dim=512, num_queries=1024, video_length=16, embedding_dim=4,
            output_dim=4, depth=12, timestep_embedding_type="sinusoidal_embedded",
            use_plucker_embedding=False,
        ),
        use_cross_normalization=False,
        use_zero_conv_latent_input=True,
        use_semantic_branch=True,
        loss_type="l2_log",
        **_DIFFUSION_256,
    )


PRESETS = {
    "dynamicrafter_256": dynamicrafter_256,
    "cami2v_256": cami2v_256,
    "camcontexti2v_256": camcontexti2v_256,
}


def camcontexti2v_256_train() -> TrainConfig:
    """The flagship's training recipe: `camc2v_tpu/config_yaml.py::
    build_train_config` of configs/models/camcontexti2v_256.yaml (the port
    holds the values; it has no yaml reader). Trains the adaptor, the
    Resampler and the zero conv (97M of 2.85B parameters) with AdamW at
    1e-4, weight decay 1e-2, global-norm clip 0.5, 4 accumulated
    micro-batches, frozen weights in bf16, no EMA."""
    return TrainConfig(
        learning_rate=1e-4, scale_lr=False, weight_decay=1e-2, grad_clip=0.5, accumulate_grad_batches=4,
        use_ema=False, ema_decay=0.9999, trainable_patterns=(r"^adaptor/", r"^image_proj/", r"^zero_conv/"),
        frozen_param_dtype="bfloat16", lr_schedule=None, max_steps=50000,
    )


def _model_class(config: DynamiCrafterConfig):
    """The port's model class of a configuration."""
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V
    from camc2v_tpu_torch.models.camera_base import CamI2V
    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter

    for cfg_cls, cls in ((CamContextI2VConfig, CamContextI2V), (CamI2VConfig, CamI2V)):
        if isinstance(config, cfg_cls):
            return cls
    return DynamiCrafter


def _seeded_model(name: str, device, seed: int, dtype):
    """The preset `name` built on `device` with seeded random f32 weights
    (`utils.weights.init_weights`, no checkpoint in the repository). On the
    card the matmul numerics are pinned first (`configure_numerics`).
    Raises on a machine without CUDA unless the caller asks for the CPU."""
    from camc2v_tpu_torch import configure_numerics
    from camc2v_tpu_torch.utils.weights import init_weights

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{name}: CUDA is not available; pass device='cpu' to build on the CPU")
        configure_numerics()
    config = PRESETS[name]()
    with torch.device(device):
        model = _model_class(config)(config, dtype=dtype)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model


def build(name: str, *, device="cuda", seed: int = 0, dtype=torch.bfloat16):
    """The preset `name` as an inference model on `device`: seeded random
    weights, Dense/Conv weights stored in `dtype`, eval mode."""
    from camc2v_tpu_torch.utils.weights import cast_for_inference

    return cast_for_inference(_seeded_model(name, device, seed, dtype).eval(), dtype)


def build_for_training(name: str, *, device="cuda", seed: int = 0, dtype=torch.bfloat16):
    """The preset `name` as a model to train on `device`: seeded random fp32
    weights, compute in `dtype`, train mode (dropout and block remat follow
    `apply_model`'s `deterministic` flag, as in the JAX package).
    `parallel.trainer.init_train_state` then casts the frozen weights to the
    recipe's `frozen_param_dtype`, keeping fp32 masters of the trainable
    subset, and builds the optimizer. Same device rule as `build`."""
    return _seeded_model(name, device, seed, dtype).train()
