"""COLMAP/GLOMAP camera-pose recovery wrapper (evaluation-only subprocesses),
a copy of `camc2v_tpu/eval/colmap.py` whose frame dump needs no OpenCV.

reference: CamContextI2V/03_evaluation.py:153-232 — feature extraction,
sequential matching, glomap mapping over frames dumped from a generated video,
then conversion of the recovered w2c trajectory to relative c2w for
RotErr/TransErr/CamMC. The binaries stay external (as in the reference);
their absence raises a clear error at call time.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

import numpy as np


def have_colmap() -> bool:
    return shutil.which("colmap") is not None and shutil.which("glomap") is not None


def dump_frames(video_path: str, out_dir: str) -> int:
    """Write per-frame PNGs (the reference uses moviepy; `data/image_io.py`
    here). The video is read by `data/video_io.py` (`.mp4` or `.npz`)."""
    from camc2v_tpu_torch.data.image_io import write_png
    from camc2v_tpu_torch.data.video_io import VideoReader

    os.makedirs(out_dir, exist_ok=True)
    reader = VideoReader(video_path)
    frames = reader.read_all()
    for i, f in enumerate(frames):
        write_png(os.path.join(out_dir, f"{i:05d}.png"), f)
    reader.close()
    return len(frames)


def _run(*cmd: str, verbose: bool = False) -> None:
    out = None if verbose else subprocess.DEVNULL
    subprocess.run(list(cmd), check=True, stdout=out, stderr=out)


def compute_camera_poses(frames_dir: str, workspace: str, verbose: bool = False) -> str:
    """COLMAP features + sequential matching, GLOMAP mapping.

    reference: 03_evaluation.py:219-223. Returns the sparse-model directory.
    """
    if not have_colmap():
        raise RuntimeError("colmap/glomap binaries not found on PATH — camera-pose "
                           "evaluation needs them installed (evaluation-only dependency)")
    os.makedirs(workspace, exist_ok=True)
    db = os.path.join(workspace, "database.db")
    sparse = os.path.join(workspace, "sparse")
    os.makedirs(sparse, exist_ok=True)
    _run("colmap", "feature_extractor", "--database_path", db, "--image_path", frames_dir,
         "--ImageReader.camera_model", "SIMPLE_PINHOLE", "--ImageReader.single_camera", "1",
         verbose=verbose)
    _run("colmap", "sequential_matcher", "--database_path", db, verbose=verbose)
    _run("glomap", "mapper", "--database_path", db, "--image_path", frames_dir,
         "--output_path", sparse, verbose=verbose)
    return os.path.join(sparse, "0")


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) -> rotation matrix.

    reference: utils/evaluation.py:475-489.
    """
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
    ])


def read_images_txt(path: str) -> dict[str, np.ndarray]:
    """COLMAP images.txt -> {image_name: w2c 4x4} (vendored-reader equivalent,
    reference: utils/evaluation.py:118-473)."""
    poses = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    for i in range(0, len(lines), 2):  # every image has a 2nd line of points
        parts = lines[i].split()
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        name = parts[9]
        rt = np.eye(4)
        rt[:3, :3] = qvec2rotmat(qvec)
        rt[:3, 3] = tvec
        poses[name] = rt
    return poses


# ------------------------------------------------------------ binary models
# Native readers for COLMAP's .bin model format (no model_converter shell-out).
# Format: https://colmap.github.io/format.html; reference vendors the same
# readers in utils/evaluation.py:118-473.

_CAMERA_MODEL_NUM_PARAMS = {
    0: 3,   # SIMPLE_PINHOLE
    1: 4,   # PINHOLE
    2: 4,   # SIMPLE_RADIAL
    3: 5,   # RADIAL
    4: 8,   # OPENCV
    5: 8,   # OPENCV_FISHEYE
    6: 12,  # FULL_OPENCV
    7: 5,   # FOV
    8: 4,   # SIMPLE_RADIAL_FISHEYE
    9: 5,   # RADIAL_FISHEYE
    10: 12, # THIN_PRISM_FISHEYE
}


def read_images_bin(path: str) -> dict[str, np.ndarray]:
    """COLMAP images.bin -> {image_name: w2c 4x4}."""
    import struct

    poses = {}
    with open(path, "rb") as f:
        (num_images,) = struct.unpack("<Q", f.read(8))
        for _ in range(num_images):
            data = struct.unpack("<idddddddi", f.read(64))
            qvec = np.array(data[1:5])
            tvec = np.array(data[5:8])
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_points,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * num_points, 1)  # (x, y double) + point3D_id int64
            rt = np.eye(4)
            rt[:3, :3] = qvec2rotmat(qvec)
            rt[:3, 3] = tvec
            poses[name.decode()] = rt
    return poses


def read_cameras_bin(path: str) -> dict[int, dict]:
    """COLMAP cameras.bin -> {camera_id: {model_id, width, height, params}}."""
    import struct

    cams = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            n_params = _CAMERA_MODEL_NUM_PARAMS[model_id]
            params = np.array(struct.unpack(f"<{n_params}d", f.read(8 * n_params)))
            cams[cam_id] = {
                "model_id": model_id, "width": width, "height": height, "params": params,
            }
    return cams


def read_points3d_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """COLMAP points3D.bin -> (xyz (N, 3), rgb (N, 3) uint8)."""
    import struct

    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            data = struct.unpack("<QdddBBBd", f.read(43))
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, 1)  # (image_id, point2D_idx) int32 pairs
    return np.asarray(xyzs, np.float64).reshape(-1, 3), np.asarray(rgbs, np.uint8).reshape(-1, 3)


def read_model_poses(sparse_dir: str) -> dict[str, np.ndarray]:
    """{image_name: w2c 4x4} from a sparse model dir, bin preferred over txt."""
    bin_path = os.path.join(sparse_dir, "images.bin")
    if os.path.exists(bin_path):
        return read_images_bin(bin_path)
    txt_path = os.path.join(sparse_dir, "images.txt")
    if os.path.exists(txt_path):
        return read_images_txt(txt_path)
    return {}


def export_poses(sparse_dir: str, out_dir: str) -> Optional[np.ndarray]:
    """Write per-frame relative c2w poses (the reference's
    write_depth_pose_from_colmap_format pose side, utils/evaluation.py:545-604).

    Saves pose_{i}.npy (4x4 c2w, relative to the first recovered frame) and
    returns the stacked (N, 4, 4) array.
    """
    poses = read_model_poses(sparse_dir)
    if not poses:
        return None
    names = sorted(poses)
    w2c = np.stack([poses[n] for n in names])
    c2w = np.linalg.inv(w2c)
    rel = np.linalg.inv(c2w[0])[None] @ c2w
    os.makedirs(out_dir, exist_ok=True)
    for i, p in enumerate(rel):
        np.save(os.path.join(out_dir, f"pose_{i}.npy"), p)
    return rel


def export_depth_maps(sparse_dir: str, out_dir: str) -> int:
    """Sparse depth maps from points3D reprojection (reference depth-side of
    write_depth_pose_from_colmap_format). Returns #maps written."""
    cams_path = os.path.join(sparse_dir, "cameras.bin")
    pts_path = os.path.join(sparse_dir, "points3D.bin")
    if not (os.path.exists(cams_path) and os.path.exists(pts_path)):
        return 0
    cams = read_cameras_bin(cams_path)
    xyz, _ = read_points3d_bin(pts_path)
    poses = read_model_poses(sparse_dir)
    if not poses or not cams:
        return 0
    cam = next(iter(cams.values()))
    W, H = int(cam["width"]), int(cam["height"])
    f = cam["params"][0]
    cx, cy = cam["params"][-2], cam["params"][-1]
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for name in sorted(poses):
        w2c = poses[name]
        p_cam = (w2c[:3, :3] @ xyz.T + w2c[:3, 3:4]).T  # (N, 3)
        z = p_cam[:, 2]
        front = z > 1e-6
        u = np.round(f * p_cam[front, 0] / z[front] + cx).astype(int)
        v = np.round(f * p_cam[front, 1] / z[front] + cy).astype(int)
        ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
        depth = np.zeros((H, W), np.float32)
        depth[v[ok], u[ok]] = z[front][ok].astype(np.float32)
        np.save(os.path.join(out_dir, f"depth_{os.path.splitext(name)[0]}.npy"), depth)
        n += 1
    return n


def recovered_trajectory(sparse_dir: str) -> Optional[np.ndarray]:
    """Sorted (N, 4, 4) w2c trajectory from a sparse model (bin or txt)."""
    poses = read_model_poses(sparse_dir)
    if not poses:
        return None
    names = sorted(poses)
    return np.stack([poses[n] for n in names])
