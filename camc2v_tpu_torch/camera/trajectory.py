"""Camera-trajectory tools: lerp, Bézier remap, quaternion slerp resampling
(a copy of `camc2v_tpu/camera/trajectory.py`).

reference: CamContextI2V/data/utils.py:8-52 (relative pose, pose lerp),
main/runtime.py:36-56 (cubic-Bézier time remap), utils/transforms.py:4-130
(quaternion slerp pose resampling). All pure numpy, host-side.
"""

from __future__ import annotations

import numpy as np


def relative_pose_to_index(rt: np.ndarray, mode: str = "left", ref_index: int = 0) -> np.ndarray:
    """(F, 4, 4) poses relative to a reference frame. reference: data/utils.py:8-18."""
    if mode == "left":
        return np.linalg.inv(rt[ref_index]) @ rt
    return rt @ np.linalg.inv(rt[ref_index])


def camera_pose_lerp(c2w: np.ndarray, target_frames: int) -> np.ndarray:
    """Linear matrix interpolation to a target frame count.

    reference: data/utils.py:47-52.
    """
    weights = np.linspace(0, c2w.shape[0] - 1, target_frames)
    left = np.floor(weights).astype(int)
    right = np.ceil(weights).astype(int)
    frac = (weights - left)[:, None, None]
    return c2w[left] * (1 - frac) + c2w[right] * frac


def bezier_curve(t: np.ndarray, a: float | None, b: float | None) -> np.ndarray:
    """Cubic Bézier through (0,0), (a,0), (b,1), (1,1). reference: runtime.py:36-41."""
    a = 0.5 if a is None else a
    b = 0.5 if b is None else b
    points = np.array([[0.0, 0.0], [a, 0.0], [b, 1.0], [1.0, 1.0]])
    coeffs = np.stack([(1 - t) ** 3, 3 * t * (1 - t) ** 2, 3 * t**2 * (1 - t), t**3])
    return points.T @ coeffs  # (2, N)


def camera_pose_lerp_bezier(
    c2w: np.ndarray, target_frames: int, coef_a: float | None, coef_b: float | None
) -> np.ndarray:
    """Bézier-remapped pose interpolation (speed-profile control).

    reference: runtime.py:44-56.
    """
    t = np.linspace(0, 1, target_frames)
    xs, ys = bezier_curve(t, coef_a, coef_b)
    right = np.searchsorted(xs, t)
    left = np.clip(right - 1, 0, None)
    right = np.clip(right, 0, len(xs) - 1)
    x_w = np.clip((t - xs[left]) / np.clip(xs[right] - xs[left], 1e-9, None), 0.0, 1.0)
    y_w = (ys[left] * (1 - x_w) + ys[right] * x_w) * (c2w.shape[0] - 1)
    li = np.floor(y_w).astype(int)
    ri = np.ceil(y_w).astype(int)
    frac = (y_w - li)[:, None, None]
    return c2w[li] * (1 - frac) + c2w[ri] * frac


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (w, x, y, z) unit quaternion. reference: utils/transforms.py:4-36."""
    trace = np.trace(R)
    if trace > 0:
        s = np.sqrt(trace + 1.0) * 2.0
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    return q / np.linalg.norm(q)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def slerp(q1: np.ndarray, q2: np.ndarray, fraction: float) -> np.ndarray:
    """Spherical quaternion interpolation. reference: utils/transforms.py:55-90."""
    dot = float(np.dot(q1, q2))
    if dot < 0.0:
        q2 = -q2
        dot = -dot
    if dot > 0.9995:
        out = q1 + fraction * (q2 - q1)
        return out / np.linalg.norm(out)
    theta0 = np.arccos(np.clip(dot, -1, 1))
    theta = theta0 * fraction
    s1 = np.sin(theta0 - theta) / np.sin(theta0)
    s2 = np.sin(theta) / np.sin(theta0)
    return s1 * q1 + s2 * q2


def resample_poses_slerp(poses: np.ndarray, target_frames: int) -> np.ndarray:
    """(F, 4, 4) -> (target, 4, 4): slerp rotations, lerp translations.

    reference: utils/transforms.py:93-130.
    """
    f = poses.shape[0]
    weights = np.linspace(0, f - 1, target_frames)
    out = np.zeros((target_frames, 4, 4))
    out[:, 3, 3] = 1.0
    for i, w in enumerate(weights):
        lo = int(np.floor(w))
        hi = int(np.ceil(w))
        frac = w - lo
        q = slerp(matrix_to_quaternion(poses[lo, :3, :3]), matrix_to_quaternion(poses[hi, :3, :3]), frac)
        out[i, :3, :3] = quaternion_to_matrix(q)
        out[i, :3, 3] = poses[lo, :3, 3] * (1 - frac) + poses[hi, :3, 3] * frac
    return out


def extend_trajectory_autoregressive(c2w: np.ndarray, num_chunks: int) -> np.ndarray:
    """Repeat the trajectory's relative motion to extend it for auto-regressive
    generation: each new chunk continues from the last pose with the same
    relative motion. reference: main/runtime.py:186-198.
    """
    if num_chunks <= 1:
        return c2w
    chunks = [c2w]
    delta = c2w[-1] @ np.linalg.inv(c2w[0])
    cur = c2w
    for _ in range(num_chunks - 1):
        cur = np.einsum("ij,fjk->fik", delta, cur)
        chunks.append(cur)
    return np.concatenate(chunks, axis=0)
