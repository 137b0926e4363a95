"""Metrics over generated per-video directories, the port's `03_evaluation.py`.

    python -m camc2v_tpu_torch.main.evaluate --path results/generation --output results \\
        [--extended] [--no-lpips] [--fvd --i3d-weights i3d.npz] [--camera --trials 5] \\
        [--max-videos N] [--device cuda|cpu]

It reads the tree that `main/generate.py` writes (one directory per video
with `generated` and `ground_truth` videos, `.mp4` or `.npz`, and
`camera_data.npy`) and appends one row to `<output>/evaluation.csv`
(`append_row`: under the file's header, which grows to take new columns):
  * `--extended` (also when no other metric is asked for): MSE / RMSE / PSNR
    / SSIM averaged over the videos, computed in float64 on `--device`
    (`eval/video_metrics.py`), and LPIPS unless `--no-lpips` where
    torchmetrics and its weights are installed (a line says why not
    otherwise);
  * `--fvd`: FVD of the videogpt (logits) and stylegan (pool) variants with
    the converted I3D weights of `--i3d-weights` (or `I3D_WEIGHTS_PATH`);
    without them each variant prints why it was skipped. The repository
    ships no such file (`tools/convert_i3d_weights.py` makes one);
  * `--camera`: RotErr / TransErr / CamMC of the generated videos' poses
    recovered by COLMAP + GLOMAP against `camera_data.npy`, the best of
    `--trials` reconstructions per video; raises when the binaries are not
    on PATH.
The device work runs on the card by default; without CUDA it raises unless
`--device cpu` is given. The library functions (`run_extended`, `run_fvd`,
`eval/video_metrics.py`, `eval/fvd.py::FVDScorer`) follow the same rule with
their `device` argument.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import tempfile
from glob import glob
from typing import Optional

import numpy as np

from camc2v_tpu_torch.utils.save_video import generated_exists


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(prog="python -m camc2v_tpu_torch.main.evaluate")
    ap.add_argument("--path", required=True, help="generation output directory")
    ap.add_argument("--output", default="results")
    ap.add_argument("--fvd", action="store_true")
    ap.add_argument("--camera", action="store_true")
    ap.add_argument("--extended", action="store_true")
    ap.add_argument("--no-lpips", action="store_true")
    ap.add_argument("--i3d-weights", default=None)
    ap.add_argument("--max-videos", type=int, default=None)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def video_dirs(path: str) -> list[str]:
    return sorted(d for d in glob(os.path.join(path, "*")) if generated_exists(d))


def video_path(vdir: str, stem: str) -> str:
    """`<vdir>/<stem>.mp4`, else `<stem>.npz`."""
    mp4 = os.path.join(vdir, stem + ".mp4")
    return mp4 if os.path.exists(mp4) else os.path.join(vdir, stem + ".npz")


def load_video(path: str) -> np.ndarray:
    from camc2v_tpu_torch.data.video_io import VideoReader

    r = VideoReader(path)
    frames = r.read_all()
    r.close()
    return frames


def run_extended(dirs: list[str], with_lpips: bool = True, device="cuda") -> dict:
    from camc2v_tpu_torch.eval.video_metrics import lpips_unavailable, metric_device, video_pair_metrics

    device = metric_device(device, "run_extended")
    if with_lpips:
        reason = lpips_unavailable()
        if reason is not None:
            print(f"LPIPS not computed: {reason}")
            with_lpips = False
    agg: dict[str, list] = {}
    for d in dirs:
        gt = load_video(video_path(d, "ground_truth"))
        gen = load_video(video_path(d, "generated"))
        m = video_pair_metrics(gt, gen, with_lpips=with_lpips, device=device)
        for k, v in m.items():
            if np.isscalar(v):
                agg.setdefault(k, []).append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def fvd_videos(dirs: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """(real, generated) [-1, 1] float32 (N, T, H, W, 3), cut to the shortest video."""
    real = [load_video(video_path(d, "ground_truth")).astype(np.float32) / 127.5 - 1 for d in dirs]
    gen = [load_video(video_path(d, "generated")).astype(np.float32) / 127.5 - 1 for d in dirs]
    t = min(min(len(v) for v in real), min(len(v) for v in gen))
    return np.stack([v[:t] for v in real]), np.stack([v[:t] for v in gen])


def run_fvd(dirs: list[str], variant: str, weights: Optional[str], device="cuda") -> float:
    from camc2v_tpu_torch.eval.fvd import FVDScorer
    from camc2v_tpu_torch.eval.video_metrics import metric_device

    scorer = FVDScorer(weights, variant, device=metric_device(device, "run_fvd"))
    return scorer(*fvd_videos(dirs))


def run_camera(dirs: list[str], trials: int = 5, verbose: bool = False) -> dict:
    """COLMAP/GLOMAP pose recovery -> RotErr/TransErr/CamMC vs camera_data.npy.

    reference: 03_evaluation.py:301-420 (5 trials/video, best-effort on
    reconstruction failures).
    """
    from camc2v_tpu_torch.eval import camera_metrics as CM
    from camc2v_tpu_torch.eval.colmap import compute_camera_poses, dump_frames, have_colmap, recovered_trajectory

    if not have_colmap():
        raise RuntimeError("colmap/glomap not on PATH")
    rot_list, trans_list, cammc_list = [], [], []
    for d in dirs:
        cam_file = os.path.join(d, "camera_data.npy")
        if not os.path.exists(cam_file):
            continue
        camera_data = np.load(cam_file)
        gt_w2c = CM.rt34_to_44(camera_data[:, 7:].reshape(-1, 3, 4))
        gt_c2w_rel = CM.relative_pose(np.linalg.inv(gt_w2c), mode="left")
        best = None
        for trial in range(trials):
            with tempfile.TemporaryDirectory() as tmp:
                frames = os.path.join(tmp, "frames")
                n = dump_frames(video_path(d, "generated"), frames)
                try:
                    sparse = compute_camera_poses(frames, os.path.join(tmp, "ws"), verbose)
                    traj = recovered_trajectory(sparse)
                except Exception:
                    traj = None
                if traj is None or len(traj) != n:
                    continue
                rec_c2w_rel = CM.relative_pose(np.linalg.inv(traj), mode="left")
                t = min(len(gt_c2w_rel), len(rec_c2w_rel))
                errs = CM.camera_metric(gt_c2w_rel[:t], rec_c2w_rel[:t])
                if best is None or errs[2] < best[2]:
                    best = errs
        if best is not None:
            rot_list.append(best[0])
            trans_list.append(best[1])
            cammc_list.append(best[2])
    return {
        "RotErr": float(np.mean(rot_list)) if rot_list else float("nan"),
        "TransErr": float(np.mean(trans_list)) if trans_list else float("nan"),
        "CamMC": float(np.mean(cammc_list)) if cammc_list else float("nan"),
        "n_videos": len(rot_list),
    }


def main(argv: Optional[list] = None) -> dict:
    """Evaluate; returns the row appended to `<output>/evaluation.csv`."""
    from camc2v_tpu_torch.main.generate import resolve_device

    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    device = resolve_device(args.device)
    dirs = video_dirs(args.path)
    if args.max_videos:
        dirs = dirs[: args.max_videos]
    print(f"evaluating {len(dirs)} videos from {args.path} on {device}")
    row: dict = {"path": args.path, "n_videos": len(dirs)}

    if args.extended or not (args.fvd or args.camera):
        row.update(run_extended(dirs, with_lpips=not args.no_lpips, device=device))
        print({k: v for k, v in row.items() if k not in ("path",)})
    if args.fvd:
        for variant in ("videogpt", "stylegan"):
            try:
                row[f"fvd_{variant}"] = run_fvd(dirs, variant, args.i3d_weights, device=device)
            except FileNotFoundError as e:
                print(f"fvd_{variant} skipped: {e}")
    if args.camera:
        row.update(run_camera(dirs, trials=args.trials))

    os.makedirs(args.output, exist_ok=True)
    csv_path = os.path.join(args.output, "evaluation.csv")
    append_row(csv_path, row)
    print(f"appended results to {csv_path}")
    return row


def append_row(csv_path: str, row: dict) -> None:
    """Append `row` under the file's header (a new file's is `sorted(row)`).
    A row with columns the header lacks rewrites the file under the union of
    both, the older rows empty there: the JAX CLI would write such a row
    under the old header, its values in the wrong columns."""
    fields, rows = [], []
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            reader = csv.DictReader(f)
            fields, rows = list(reader.fieldnames or []), list(reader)
    new = [k for k in sorted(row) if k not in fields]
    with open(csv_path, "w" if new else "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields + new, restval="")
        if new:
            w.writeheader()
            w.writerows(rows)
        w.writerow(row)


if __name__ == "__main__":
    main()
