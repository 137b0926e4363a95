"""Camera-pose error metrics: RotErr / TransErr / CamMC (a copy of
`camc2v_tpu/eval/camera_metrics.py`).

reference: CamContextI2V/03_evaluation.py:235-298 and
utils/evaluation.py:628-651. All pure numpy over (N, 4, 4) / (N, 3, 4) pose
arrays; used on COLMAP/GLOMAP-recovered trajectories vs the ground-truth
`camera_data.npy` poses.
"""

from __future__ import annotations

import numpy as np


def rt34_to_44(rt: np.ndarray) -> np.ndarray:
    bottom = np.tile(np.array([[[0.0, 0.0, 0.0, 1.0]]]), (rt.shape[0], 1, 1))
    return np.concatenate([rt[:, :3, :4], bottom], axis=1)


def relative_pose(rt: np.ndarray, mode: str = "left") -> np.ndarray:
    """Poses relative to the first frame. reference: utils/evaluation.py:638-643."""
    eye = np.eye(4)[None]
    if mode == "left":
        rel = np.linalg.inv(rt[:1]) @ rt[1:]
    else:
        rel = rt[1:] @ np.linalg.inv(rt[:1])
    return np.concatenate([eye, rel], axis=0)


def normalize_t(rt: np.ndarray, ref: np.ndarray | None = None, eps: float = 1e-9) -> np.ndarray:
    """Scale-normalise translations by the max norm of the reference trajectory.

    reference: utils/evaluation.py:646-650.
    """
    ref = rt if ref is None else ref
    scale = np.linalg.norm(ref[:, :3, 3], axis=1).max() + eps
    out = np.concatenate([rt[:, :3, :3], rt[:, :3, 3:4] / scale], axis=-1)
    return rt34_to_44(out)


def calc_roterr(r1: np.ndarray, r2: np.ndarray) -> np.ndarray:
    """Geodesic rotation error in radians. reference: 03_evaluation.py:235-247."""
    tr = np.einsum("nij,nij->n", r1, r2)  # trace(r1^T @ r2)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def calc_transerr(t1: np.ndarray, t2: np.ndarray) -> np.ndarray:
    return np.linalg.norm(t2 - t1, axis=-1)


def calc_cammc(rt1: np.ndarray, rt2: np.ndarray) -> np.ndarray:
    return np.linalg.norm((rt2 - rt1).reshape(-1, 12), axis=-1)


def camera_metric(c2w_1: np.ndarray, c2w_2: np.ndarray) -> tuple[float, float, float]:
    """(RotErr, TransErr, CamMC) sums over a trajectory pair.

    reference: 03_evaluation.py:276-298 — translations are scale-normalised
    per-trajectory before TransErr/CamMC.
    """
    rot = float(calc_roterr(c2w_1[:, :3, :3], c2w_2[:, :3, :3]).sum())
    rel1 = normalize_t(c2w_1, c2w_1)
    rel2 = normalize_t(c2w_2, c2w_2)
    trans = float(calc_transerr(rel1[:, :3, 3], rel2[:, :3, 3]).sum())
    cammc = float(calc_cammc(rel1[:, :3, :4], rel2[:, :3, :4]).sum())
    return rot, trans, cammc
