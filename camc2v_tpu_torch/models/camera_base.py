"""Camera-controlled LVDM base and CamI2V (`camc2v_tpu/models/camera_base.py`;
reference model/base.py:20-482 and baseline/cami2v/cami2v.py:21-241).

CamI2V conditions the UNet's temporal blocks on the camera through the
Plücker pose encoder's feature pyramid (`pluker_projection`) and epipolar
attention (`UNetConfig.use_camera`, `UNetConfig.epipolar`).
`CamI2V.camera_condition` builds the payload once per request: the relative
poses, the fundamental matrices of every frame pair, the epipolar lines and
kernel tile maps of every level (`prepare_plain_epipolar`), and the Plücker
pyramid; it rides cond["camera"] through every denoise step. MotionCtrl and
CameraCtrl are not ported.

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
