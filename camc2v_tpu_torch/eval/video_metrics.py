"""Frame-quality metrics on a device: MSE / RMSE / PSNR / SSIM (+LPIPS where
torchmetrics and its weights are at hand), `camc2v_tpu/eval/video_metrics.py`.

The JAX package computes these with numpy/scipy on the host. Here the frames
go to `device` as uint8 and every metric is computed in float64 there, so
the numbers are the host's to rounding (~1e-12). SSIM is the same Gaussian
11x11 window (sigma 1.5, outer product, "valid"), K1 0.01, K2 0.03 at
data_range 255: the (T*C) planes go through one `F.conv2d` per statistic,
and the map's mean is taken per channel, then over channels, then over
frames, as the JAX function orders it. LPIPS is computed only where
`lpips_unavailable()` finds torchmetrics and the backbone's pretrained
weights in the torch hub cache (nothing is downloaded); otherwise the
metrics have no `lpips` key, as in JAX, and any other error raises.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float64)


def mse(a, b, device="cpu") -> float:
    """Mean squared error over uint8-range frames."""
    return float(((_f64(a, device) - _f64(b, device)) ** 2).mean())


def rmse(a, b, device="cpu") -> float:
    return float(np.sqrt(mse(a, b, device)))


def psnr(a, b, data_range: float = 255.0, device="cpu") -> float:
    return _psnr(mse(a, b, device), data_range)


def _psnr(m: float, data_range: float = 255.0) -> float:
    return float(10 * np.log10(data_range**2 / max(m, 1e-12)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g /= g.sum()
    return np.outer(g, g)


def _ssim_frames(a: torch.Tensor, b: torch.Tensor, data_range: float) -> torch.Tensor:
    """(N,) SSIM of each of N (H, W, C) float64 frame pairs."""
    n, h, w, c = a.shape
    k = torch.from_numpy(_gaussian_kernel()).to(a)[None, None]
    x = a.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    y = b.permute(0, 3, 1, 2).reshape(n * c, 1, h, w)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x, mu_y = F.conv2d(x, k), F.conv2d(y, k)
    xx = F.conv2d(x * x, k) - mu_x**2
    yy = F.conv2d(y * y, k) - mu_y**2
    xy = F.conv2d(x * y, k) - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * xy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (xx + yy + c2))
    return s.mean(dim=(1, 2, 3)).reshape(n, c).mean(dim=1)


def ssim(a, b, data_range: float = 255.0, device="cpu") -> float:
    """SSIM over (H, W, C) or (N, H, W, C) frames (Gaussian 11x11, K1/K2 std)."""
    a, b = _f64(a, device), _f64(b, device)
    if a.ndim == 3:
        a, b = a[None], b[None]
    return float(_ssim_frames(a, b, data_range).mean())


_LPIPS_BACKBONES = {"squeeze": "SqueezeNet1_1_Weights", "alex": "AlexNet_Weights", "vgg": "VGG16_Weights"}


def lpips_unavailable(net: str = "squeeze") -> Optional[str]:
    """Why LPIPS cannot be computed here without a download, or None."""
    for pkg in ("torchmetrics", "torchvision"):
        if importlib.util.find_spec(pkg) is None:
            return f"{pkg} is not installed"
    import torchvision.models

    url = getattr(torchvision.models, _LPIPS_BACKBONES[net]).IMAGENET1K_V1.url
    path = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(url))
    if not os.path.exists(path):
        return f"the {net} backbone's pretrained weights are not at {path} (they are not downloaded)"
    return None


def lpips(a, b, net: str = "squeeze", device="cpu") -> float:
    """LPIPS (torchmetrics) of uint8 (N, H, W, 3) frames; call only where
    `lpips_unavailable(net)` is None."""
    from torchmetrics.image.lpip import LearnedPerceptualImagePatchSimilarity

    m = LearnedPerceptualImagePatchSimilarity(net_type=net).to(device)
    ta = (_f64(a, device).float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    tb = (_f64(b, device).float() / 127.5 - 1.0).permute(0, 3, 1, 2)
    with torch.no_grad():
        return float(m(ta, tb))


def video_pair_metrics(gt, gen, with_lpips: bool = True, device="cpu") -> dict:
    """Per-video metric dict over uint8 (T, H, W, 3) frame stacks.

    Also returns per-timestep MSE (reference computes per-timestep breakdowns,
    03_evaluation.py:470-516).
    """
    t = min(len(gt), len(gen))
    a, b = _f64(gt[:t], device), _f64(gen[:t], device)
    sq = (a - b) ** 2
    per_t_mse = [float(v) for v in sq.mean(dim=(1, 2, 3)).cpu()]
    out = {
        "mse": float(np.mean(per_t_mse)),
        "rmse": float(np.sqrt(np.mean(per_t_mse))),
        "psnr": _psnr(float(sq.mean())),
        "ssim": float(_ssim_frames(a, b, 255.0).mean()),
        "mse_per_timestep": per_t_mse,
    }
    if with_lpips and lpips_unavailable() is None:
        out["lpips"] = lpips(gt[:t], gen[:t], device=device)
    return out
