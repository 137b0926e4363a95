"""Camera-trajectory visual export (OBJ point cloud / frustum wireframes; a
copy of `camc2v_tpu/utils/camera_trace.py`).

reference: CamContextI2V/main/runtime.py:348-374 + data/utils.py:21-44 export
the camera trace via open3d; here we write plain Wavefront OBJ (no native
dependency) with the same world-flip convention ([-1,-1,1] diag, reference
data/utils.py:33-43).
"""

from __future__ import annotations

import numpy as np

_FLIP = np.diag([-1.0, -1.0, 1.0])


def line_points(start: np.ndarray, end: np.ndarray, num: int = 50) -> np.ndarray:
    """Points along a segment (reference create_line_point_cloud)."""
    return np.linspace(start, end, num)


def trajectory_points(c2w: np.ndarray, points_per_segment: int = 50) -> np.ndarray:
    """(F, 4, 4) camera-to-world -> dense polyline through camera centres."""
    centers = c2w[:, :3, 3]
    segs = [line_points(centers[i], centers[i + 1], points_per_segment) for i in range(len(centers) - 1)]
    pts = np.concatenate(segs, axis=0) if segs else centers
    return pts @ _FLIP.T


def frustum_points(c2w: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """Wireframe pyramid for each camera pose."""
    corners = np.array(
        [[0, 0, 0], [-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]], dtype=np.float64
    ) * scale
    pts = []
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    for pose in c2w:
        world = corners @ pose[:3, :3].T + pose[:3, 3]
        for a, b in edges:
            pts.append(line_points(world[a], world[b], 10))
    return np.concatenate(pts, axis=0) @ _FLIP.T


def export_camera_trace_obj(path: str, c2w: np.ndarray, with_frustums: bool = True) -> str:
    """Write the camera trace as an OBJ point cloud (viewable anywhere)."""
    pts = [trajectory_points(c2w)]
    if with_frustums:
        pts.append(frustum_points(c2w))
    allpts = np.concatenate(pts, axis=0)
    with open(path, "w") as f:
        f.write("# camc2v camera trace\n")
        for p in allpts:
            f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    return path
