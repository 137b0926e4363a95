"""Camera-controlled LVDM base, the MotionCtrl and CameraCtrl baselines and
CamI2V (`camc2v_tpu/models/camera_base.py`; reference model/base.py:20-482,
baseline/motionctrl/motionctrl.py, baseline/cameractrl/cameractrl.py and
baseline/cami2v/cami2v.py:21-241).

Each model differs in what its `camera_condition` returns and in the
injection its UNet's temporal blocks were built with (`nn/attention.py`):
MotionCtrl the flattened relative w2c 3x4 poses (`RT`, for every temporal
block's `cc_projection` and init_attn's; `UNetConfig.camera_mode=
'motionctrl'`); CameraCtrl the Plücker pose encoder's feature pyramid (a
zero-init `cc_projection` into attn1's input; `camera_mode='cameractrl'`);
CamI2V the Plücker pyramid (`pluker_projection`) and epipolar attention
(`UNetConfig.use_camera`, `UNetConfig.epipolar`). `CamI2V.camera_condition`
builds the payload once per request: the relative poses, the fundamental
matrices of every frame pair, the epipolar lines and kernel tile maps of
every level (`prepare_plain_epipolar`), and the Plücker pyramid. Each
payload rides cond["camera"] through every denoise step.

Batch keys on top of DynamiCrafter's:
  "RT":                (B, T, 4, 4) float w2c poses
  "camera_intrinsics": (B, T, 3, 3) float pixel-unit intrinsics
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from camc2v_tpu_torch.camera import geometry as G
from camc2v_tpu_torch.camera.pose_encoder import CameraPoseEncoder
from camc2v_tpu_torch.config import CameraControlConfig, CamI2VConfig
from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter
from camc2v_tpu_torch.nn.attention import BasicTransformerBlock
from camc2v_tpu_torch.nn.epipolar import prepare_plain_epipolar, require_plain

# seed of the zero-translation perturbation draws (the JAX package draws
# them from the fixed key jax.random.key(0); torch cannot give those bits)
PERTURB_SEED = 0


class CameraControlLVDM(DynamiCrafter):
    """Shared camera-model base: the pose encoder and relative-pose helpers."""

    def __init__(self, config: CameraControlConfig, dtype=torch.bfloat16):
        super().__init__(config, dtype=dtype)
        self.pose_encoder = CameraPoseEncoder(config.pose_encoder, dtype=dtype) \
            if config.pose_encoder is not None else None

    def relative_c2w_from_batch(self, batch: dict, cond_frame_index: torch.Tensor, trace_scale_factor: float = 1.0
                                ) -> tuple[torch.Tensor, torch.Tensor]:
        """(K, relative c2w) in f32: w2c inverted, made relative to the
        conditioning frame, the translations scaled by trace_scale_factor
        (reference model/base.py:112-198, camcontexti2v.py:529-537)."""
        K = batch["camera_intrinsics"].float()
        c2w = torch.linalg.inv(batch["RT"].float())
        rel = G.relative_pose(c2w, cond_frame_index, mode="left", normalize_T0=self.config.normalize_T0)
        rel[:, :, :3, 3] *= trace_scale_factor
        return K, rel

    def plucker_features(self, K: torch.Tensor, rel_c2w: torch.Tensor, H: int, W: int
                         ) -> Optional[tuple[torch.Tensor, ...]]:
        if self.pose_encoder is None:
            return None
        plucker = G.plucker_embedding(K, rel_c2w, H, W, return_plucker=self.config.camera_embedding == "plucker")
        return self.pose_encoder(plucker)


class MotionCtrl(CameraControlLVDM):
    """RT-matrix conditioning (reference baseline/motionctrl/motionctrl.py:
    19-71): the payload is the relative w2c 3x4 of every frame, flattened."""

    def camera_condition(self, batch: dict, cond_frame_index: torch.Tensor, *, trace_scale_factor: float = 1.0,
                         perturb_noise: Optional[torch.Tensor] = None) -> dict:
        """{"RT": (B, T, 12)}: the inverse of the relative c2w poses, rows
        0-2 of each, flattened (perturb_noise is unused: no epipolar
        geometry)."""
        _, rel_c2w = self.relative_c2w_from_batch(batch, cond_frame_index, trace_scale_factor)
        rel_w2c = torch.linalg.inv(rel_c2w)
        b, t = rel_w2c.shape[:2]
        return {"RT": rel_w2c[:, :, :3, :4].reshape(b, t, 12)}


class CameraCtrl(CameraControlLVDM):
    """Plücker pose-encoder conditioning (reference baseline/cameractrl/
    cameractrl.py:19-80): the pose encoder's pyramid of the `ray` (or
    `plucker`) embedding, one level per temporal block's `cc_projection`."""

    def __init__(self, config: CameraControlConfig, dtype=torch.bfloat16):
        super().__init__(config, dtype=dtype)
        if self.pose_encoder is None:
            # no payload ever reaches the UNet, so (as JAX's init) no block has a cc_projection
            for m in self.unet.modules():
                if isinstance(m, BasicTransformerBlock):
                    m.cc_projection = None

    def camera_condition(self, batch: dict, cond_frame_index: torch.Tensor, *, trace_scale_factor: float = 1.0,
                         perturb_noise: Optional[torch.Tensor] = None) -> Optional[dict]:
        """{"plucker": the pose encoder's pyramid}, or None without a pose
        encoder (perturb_noise is unused)."""
        H, W = batch["video"].shape[2:4]
        K, rel_c2w = self.relative_c2w_from_batch(batch, cond_frame_index, trace_scale_factor)
        plucker = self.plucker_features(K, rel_c2w, H, W)
        return None if plucker is None else {"plucker": plucker}


class CamI2V(CameraControlLVDM):
    """Plücker + epipolar-masked attention (the machinery CamContextI2V
    extends), without context frames."""

    def __init__(self, config: CamI2VConfig, dtype=torch.bfloat16):
        super().__init__(config, dtype=dtype)
        if config.epipolar is not None:
            require_plain(config.epipolar)

    def camera_condition(self, batch: dict, cond_frame_index: torch.Tensor, *, trace_scale_factor: float = 1.0,
                         perturb_noise: Optional[torch.Tensor] = None) -> dict:
        """The UNet's camera payload (reference camcontexti2v.py:525-572),
        the poses relative to each sample's conditioning frame.

        perturb_noise: standard-normal draws of the (B, T, T, 3, 1)
        translations' shape for the zero-translation perturbation; by default
        drawn from a CPU `torch.Generator` seeded with PERTURB_SEED (the JAX
        package uses a fixed JAX key: same distribution, other bits)."""
        cfg: CamI2VConfig = self.config
        video = batch["video"]
        b, t, H, W = video.shape[:4]
        K, rel_c2w = self.relative_c2w_from_batch(batch, cond_frame_index, trace_scale_factor)
        cam: dict[str, Any] = {"cond_frame_index": cond_frame_index}
        if cfg.epipolar is not None:
            pairs = G.relative_c2w_pairs(rel_c2w)  # (B, T, T, 4, 4)
            R, tvec = pairs[..., :3, :3], pairs[..., :3, 3:4]
            if cfg.epipolar.add_small_perturbation_on_zero_T:
                if perturb_noise is None:
                    perturb_noise = torch.randn(tvec.shape, generator=torch.Generator().manual_seed(PERTURB_SEED))
                tvec = G.add_small_perturbation(tvec, perturb_noise.to(tvec.device))
            F = G.fundamental_matrix(K[:, None].expand(b, t, t, 3, 3), R, tvec)
            cam["F"] = F
            cam["epi_prep"] = prepare_plain_epipolar(F, cfg.epipolar)
        plucker = self.plucker_features(K, rel_c2w, H, W)
        if plucker is not None:
            cam["plucker"] = plucker
        return cam
