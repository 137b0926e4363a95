"""Camera geometry as float32 functions (`camc2v_tpu/camera/geometry.py`).

Plücker rays, relative poses, fundamental matrices and the plain epipolar
mask band. Everything is computed in f32 whatever the input dtype; the small
matrix products run as f32 matmuls, which stay full f32 on the card with
TF32 off (`camc2v_tpu_torch.configure_numerics`). Poses are 4x4 row-major
matrices, intrinsics 3x3 in pixels of the (H, W) video.

`add_small_perturbation` takes its standard-normal draws as an argument: the
JAX package draws them from a fixed JAX key, whose bits torch cannot
reproduce, so the caller supplies them (`CamI2V.camera_condition` uses a
fixed-seed `torch.Generator`, or the draws it is handed).
"""

from __future__ import annotations

from typing import Optional

import torch

from camc2v_tpu_torch.config import EpipolarConfig
from camc2v_tpu_torch.ops.epipolar_flash import epipolar_lines, materialize_mask


def plucker_embedding(K: torch.Tensor, c2w: torch.Tensor, H: int, W: int, *,
                      return_plucker: bool = True) -> torch.Tensor:
    """(B, V, 3, 3) intrinsics, (B, V, 4, 4) camera-to-world -> (B, V, H, W, 6):
    [o x d | d] per pixel ray, or [o | d] without `return_plucker`."""
    K, c2w = K.float(), c2w.float()
    b, v = K.shape[:2]
    jj, ii = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=K.device),
                            torch.arange(W, dtype=torch.float32, device=K.device), indexing="ij")
    i = (ii.reshape(-1) + 0.5)[None, None]
    j = (jj.reshape(-1) + 0.5)[None, None]
    fx, fy = K[..., 0, 0][..., None], K[..., 1, 1][..., None]
    cx, cy = K[..., 0, 2][..., None], K[..., 1, 2][..., None]
    xs = (i - cx) / fx
    ys = (j - cy) / fy
    zs = torch.ones(b, v, H * W, device=K.device)
    directions = torch.stack([xs.expand_as(zs), ys.expand_as(zs), zs], dim=-1)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    rays_d = torch.einsum("bvnk,bvlk->bvnl", directions, c2w[..., :3, :3])
    rays_o = c2w[..., None, :3, 3].expand_as(rays_d)
    if not return_plucker:
        return torch.cat([rays_o, rays_d], dim=-1).reshape(b, v, H, W, 6)
    rays_dxo = torch.linalg.cross(rays_o, rays_d, dim=-1)
    return torch.cat([rays_dxo, rays_d], dim=-1).reshape(b, v, H, W, 6)


def relative_pose(RT_4x4: torch.Tensor, cond_frame_index: torch.Tensor, mode: str = "left",
                  normalize_T0: bool = False) -> torch.Tensor:
    """(B, T, 4, 4) poses relative to each batch's conditioning frame."""
    RT = RT_4x4.float()
    b = RT.shape[0]
    first = RT[torch.arange(b, device=RT.device), cond_frame_index.long()][:, None]  # (B, 1, 4, 4)
    if normalize_T0:
        scale = torch.linalg.norm(first.reshape(b, -1), dim=-1).reshape(b, 1, 1, 1)
        first = first / scale
        RT = RT / scale
    inv_first = torch.linalg.inv(first)
    return inv_first @ RT if mode == "left" else RT @ inv_first


def pairwise_relative_pose(RT1: torch.Tensor, RT2: torch.Tensor, mode: str = "left") -> torch.Tensor:
    """(B, T1, T2, 4, 4): inv(RT1[b, i]) @ RT2[b, j] (left)."""
    a, b_ = RT1.float()[:, :, None], RT2.float()[:, None, :]
    return torch.linalg.inv(a) @ b_ if mode == "left" else a @ torch.linalg.inv(b_)


def relative_c2w_pairs(RT: torch.Tensor) -> torch.Tensor:
    """Frame-to-frame transforms: out[b, t1, t2] = inv(RT[t2]) @ RT[t1]."""
    RT = RT.float()
    return torch.linalg.inv(RT)[:, None, :] @ RT[:, :, None]


def fundamental_matrix(K: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """F = K^-T E K^-1 with E[:, j] = t x R[:, j]; K, R (..., 3, 3), t (..., 3, 1)."""
    K, R, t = K.float(), R.float(), t.float()
    E = torch.linalg.cross(t.expand_as(R), R, dim=-2)
    K_inv = torch.linalg.inv(K)
    return K_inv.transpose(-1, -2) @ E @ K_inv


def add_small_perturbation(t: torch.Tensor, noise: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    """Replace near-zero translations (all |components| < epsilon) with
    `noise * epsilon`; `noise` holds standard-normal draws of t's shape."""
    zero = torch.all(torch.abs(t) < epsilon, dim=-2, keepdim=True)
    return torch.where(zero, noise.to(t.dtype) * epsilon, t)


def _require_plain(config: EpipolarConfig) -> None:
    if config.apply_epipolar_soft_mask or config.epipolar_hybrid_attention or \
            config.epipolar_hybrid_attention_v2 or config.only_self_pixel_on_current_frame or \
            config.current_frame_as_register_token:
        raise NotImplementedError("epipolar_mask: only the plain distance band is ported")


def epipolar_mask(F: torch.Tensor, T: int, H: int, W: int, downsample: int,
                  config: EpipolarConfig = EpipolarConfig()) -> torch.Tensor:
    """(B, T1*H*W, T2*H*W) bool: key pixel k lies within downsample*sqrt(2)/2
    of query pixel q's epipolar line. Plain band only; built from the same
    lines and operation order as the kernel path
    (`ops.epipolar_flash.materialize_mask`). T (the JAX signature's frame
    count) is F's T2."""
    _require_plain(config)
    return materialize_mask(epipolar_lines(F, H, W, downsample), F.shape[2], H, W, downsample)


def build_epipolar_masks(F: torch.Tensor, T: int, latent_hw: tuple[int, int],
                         config: EpipolarConfig) -> dict[int, torch.Tensor]:
    """{8 * ds: (B, T*hw, T*hw)} for ds in config.attention_resolution."""
    h, w = latent_hw
    return {8 * ds: epipolar_mask(F, T, h // ds, w // ds, 8 * ds, config) for ds in config.attention_resolution}


def conditional_fundamental(camera_intrinsics: torch.Tensor, w2c_RT: torch.Tensor, w2c_RT_cond: torch.Tensor,
                            cond_frame_index: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T, C[+1], 3, 3) fundamental matrices between the target frames
    (queries) and the [cond ‖ context] frames (keys); the conditioning
    frame's pose is prepended when `cond_frame_index` is given."""
    K = camera_intrinsics.float()
    c2w = torch.linalg.inv(w2c_RT.float())
    c2w_cond = torch.linalg.inv(w2c_RT_cond.float())
    if cond_frame_index is not None:
        b = c2w.shape[0]
        sel = c2w[torch.arange(b, device=c2w.device), cond_frame_index.long()][:, None]
        c2w_cond = torch.cat([sel, c2w_cond], dim=1)
    rel = pairwise_relative_pose(c2w_cond, c2w).transpose(1, 2)  # (B, T, C, 4, 4)
    R, t = rel[..., :3, :3], rel[..., :3, 3:4]
    K_pairs = K[:, :, None].expand(K.shape[0], R.shape[1], R.shape[2], 3, 3)
    return fundamental_matrix(K_pairs, R, t)


def conditional_epipolar_mask(camera_intrinsics, w2c_RT, w2c_RT_cond, cond_frame_index, H: int, W: int,
                              downsample: int = 8, config: EpipolarConfig = EpipolarConfig()) -> torch.Tensor:
    """(B, T*hw, (C[+1])*hw) bool mask between target and context tokens."""
    F = conditional_fundamental(camera_intrinsics, w2c_RT, w2c_RT_cond, cond_frame_index)
    return epipolar_mask(F, F.shape[1], H // downsample, W // downsample, downsample, config)

