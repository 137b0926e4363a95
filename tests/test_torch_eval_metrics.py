"""The port's evaluation metrics and the 03 CLI against the JAX package.

Frame metrics (`eval/video_metrics.py`, float64 in torch) and camera
metrics (`eval/camera_metrics.py`, a numpy copy) against `camc2v_tpu.eval`
at 1e-9 relative; the COLMAP readers and exports (`eval/colmap.py`) on a
model written as `tests/test_eval_and_runtime.py` writes one, in its `.bin`
and `.txt` forms, compared exactly; `main.evaluate.main` end to end on a
tree written by the port's `log_evaluation` (`.npz` videos) with a seeded
I3D file. Three tests, so xdist queues this file after the long ones;
torch and numpy's BLAS on one thread (`one_blas_thread`).
"""

import csv
import os
import sys

import numpy as np
import pytest
import torch

import test_eval_and_runtime as JAX_EVAL_TESTS
from test_torch_eval_i3d import one_blas_thread  # noqa: F401
from test_torch_port_modules import one_torch_thread  # noqa: F401

from camc2v_tpu.eval import camera_metrics as JCM
from camc2v_tpu.eval import colmap as JC
from camc2v_tpu.eval import video_metrics as JVM

from camc2v_tpu_torch.eval import camera_metrics as CM
from camc2v_tpu_torch.eval import colmap as C
from camc2v_tpu_torch.eval import video_metrics as VM
from camc2v_tpu_torch.eval.fvd import (FVDScorer, InceptionI3D, frechet_distance, gaussian_stats, init_i3d,
                                       write_i3d_weights)
from camc2v_tpu_torch.main import evaluate
from camc2v_tpu_torch.utils.save_video import log_evaluation
from camc2v_tpu_torch.utils.weights import i3d_variables

RTOL = 1e-9


def _frames(rng, shape, noise):
    gt = rng.integers(0, 256, shape).astype(np.uint8)
    gen = np.clip(gt.astype(np.int16) + rng.integers(-noise, noise + 1, shape), 0, 255).astype(np.uint8)
    return gt, gen


def _trajectory(rng, n=6):
    out = []
    for _ in range(n):
        a, b = rng.normal(size=2) * 0.3
        rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
        rt = np.eye(4)
        rt[:3, :3] = rz @ ry
        rt[:3, 3] = rng.normal(size=3)
        out.append(rt)
    return np.stack(out)


def test_frame_and_camera_metrics_match_jax():
    rng = np.random.default_rng(0)
    for shape, noise in (((5, 32, 32, 3), 30), ((3, 41, 57, 3), 4)):
        gt, gen = _frames(rng, shape, noise)
        want = JVM.video_pair_metrics(gt, gen, with_lpips=False)
        got = VM.video_pair_metrics(gt, gen, with_lpips=False)
        assert sorted(got) == sorted(want)
        for k in ("mse", "rmse", "psnr", "ssim"):
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(got["mse_per_timestep"], want["mse_per_timestep"], rtol=RTOL)
        np.testing.assert_allclose(VM.ssim(gt[1], gen[1]), JVM.ssim(gt[1], gen[1]), rtol=RTOL)
        np.testing.assert_allclose(VM.psnr(gt, gen), JVM.psnr(gt, gen), rtol=RTOL)
        np.testing.assert_allclose(VM.rmse(gt, gen), JVM.rmse(gt, gen), rtol=RTOL)
    # a frame pair that is identical: SSIM 1, PSNR at its 1e-12 floor
    same = VM.video_pair_metrics(gt, gt, with_lpips=False)
    assert same["ssim"] == pytest.approx(1.0, rel=RTOL) and same["psnr"] == JVM.psnr(gt, gt)

    c1, c2 = _trajectory(np.random.default_rng(1)), _trajectory(np.random.default_rng(2))
    np.testing.assert_allclose(CM.camera_metric(c1, c2), JCM.camera_metric(c1, c2), rtol=RTOL)
    for mode in ("left", "right"):
        np.testing.assert_allclose(CM.relative_pose(c1, mode), JCM.relative_pose(c1, mode), rtol=RTOL, atol=1e-15)
    np.testing.assert_allclose(CM.normalize_t(c1), JCM.normalize_t(c1), rtol=RTOL)
    np.testing.assert_allclose(CM.normalize_t(c2, c1), JCM.normalize_t(c2, c1), rtol=RTOL)
    np.testing.assert_array_equal(CM.rt34_to_44(c1[:, :3]), JCM.rt34_to_44(c1[:, :3]))


def _write_images_txt(path, qvecs, tvecs):
    with open(path, "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for i, (q, t) in enumerate(zip(qvecs, tvecs)):
            f.write(f"{i + 1} {' '.join(repr(float(v)) for v in (*q, *t))} 1 {i:05d}.png\n")
            f.write("1.0 2.0 -1\n")


def _same_tree(a, b):
    for root, _, files in os.walk(a):
        for name in files:
            p = os.path.join(root, name)
            np.testing.assert_array_equal(np.load(p), np.load(os.path.join(b, os.path.relpath(p, a))), err_msg=p)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def test_colmap_readers_and_exports_match_jax(tmp_path):
    model = tmp_path / "bin"
    model.mkdir()
    qvecs, tvecs, _ = JAX_EVAL_TESTS.TestColmapBinaryModel._write_model(str(model), n=4)
    txt = tmp_path / "txt"
    txt.mkdir()
    _write_images_txt(txt / "images.txt", qvecs, tvecs)

    for fn in ("read_images_bin",):
        got, want = getattr(C, fn)(str(model / "images.bin")), getattr(JC, fn)(str(model / "images.bin"))
        assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    got, want = C.read_images_txt(str(txt / "images.txt")), JC.read_images_txt(str(txt / "images.txt"))
    assert len(got) == 4 and sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    cams, jcams = C.read_cameras_bin(str(model / "cameras.bin")), JC.read_cameras_bin(str(model / "cameras.bin"))
    assert cams.keys() == jcams.keys()
    for k in cams:
        assert {n: v for n, v in cams[k].items() if n != "params"} == {n: v for n, v in jcams[k].items()
                                                                       if n != "params"}
        np.testing.assert_array_equal(cams[k]["params"], jcams[k]["params"])
    points = str(model / "points3D.bin")
    for a, b in zip(C.read_points3d_bin(points), JC.read_points3d_bin(points)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for d in (model, txt):
        np.testing.assert_array_equal(C.recovered_trajectory(str(d)), JC.recovered_trajectory(str(d)))
        np.testing.assert_array_equal(C.export_poses(str(d), str(d / "port")), JC.export_poses(str(d), str(d / "jax")))
        assert C.export_depth_maps(str(d), str(d / "port")) == JC.export_depth_maps(str(d), str(d / "jax"))
        _same_tree(str(d / "port"), str(d / "jax"))
    assert C.recovered_trajectory(str(tmp_path)) is None and C.export_poses(str(tmp_path), str(tmp_path / "x")) is None
    assert C.have_colmap() == JC.have_colmap()

    # the frame dump writes PNGs without OpenCV, from an .npz video
    frames = np.random.default_rng(0).integers(0, 256, (3, 12, 10, 3)).astype(np.uint8)
    np.savez_compressed(tmp_path / "v.npz", frames=frames, fps=8.0)
    assert C.dump_frames(str(tmp_path / "v.npz"), str(tmp_path / "frames")) == 3
    from camc2v_tpu_torch.data.image_io import read_image

    for i in range(3):
        np.testing.assert_array_equal(read_image(str(tmp_path / "frames" / f"{i:05d}.png")), frames[i])
    if not C.have_colmap():
        with pytest.raises(RuntimeError, match="colmap/glomap"):
            C.compute_camera_poses(str(tmp_path / "frames"), str(tmp_path / "ws"))


def test_evaluate_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """`main.evaluate.main` on an `.npz` tree (OpenCV hidden) with --extended
    --no-lpips --fvd and a seeded I3D: the row is the JAX metrics of the
    same frames, and each FVD the Fréchet distance of the features the
    port's `FVDScorer` gave for the tree's real and generated videos; a
    second run appends a row. The frames are 224 high, so the scorer runs
    the network without the resize (`test_torch_eval_i3d.py` holds the
    resize and the network to JAX)."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.delenv("I3D_WEIGHTS_PATH", raising=False)
    rng = np.random.default_rng(0)
    gen_root = tmp_path / "generation"
    for i in range(2):
        gen = rng.uniform(-1, 1, (4, 224, 32, 3)).astype(np.float32)
        gt = np.clip(gen + rng.normal(scale=0.05, size=gen.shape), -1, 1).astype(np.float32)
        cam = rng.normal(size=(4, 19)).astype(np.float32)
        log_evaluation(str(gen_root), f"vid{i}", gen, gt, cam, f"cap {i}", None, fps=8)
    (gen_root / "no_video").mkdir()
    weights = str(tmp_path / "i3d.npz")
    write_i3d_weights(weights, i3d_variables(init_i3d(InceptionI3D(), torch.Generator().manual_seed(0))))
    calls = []
    extract = FVDScorer.extract_features

    def recorded(self, videos, batch_size=8):
        feats = extract(self, videos, batch_size)
        calls.append((self.variant, videos, feats))
        return feats

    monkeypatch.setattr(FVDScorer, "extract_features", recorded)

    out_dir = str(tmp_path / "results")
    argv = ["--path", str(gen_root), "--output", out_dir, "--device", "cpu"]
    row = evaluate.main(argv + ["--extended", "--no-lpips", "--fvd", "--i3d-weights", weights])
    dirs = evaluate.video_dirs(str(gen_root))
    assert [os.path.basename(d) for d in dirs] == ["vid0", "vid1"] and row["n_videos"] == 2
    assert all(os.path.exists(os.path.join(d, "generated.npz")) for d in dirs)
    per_video = [JVM.video_pair_metrics(evaluate.load_video(os.path.join(d, "ground_truth.npz")),
                                        evaluate.load_video(os.path.join(d, "generated.npz")), with_lpips=False)
                 for d in dirs]
    for k in ("mse", "rmse", "psnr", "ssim"):
        np.testing.assert_allclose(row[k], np.mean([m[k] for m in per_video]), rtol=RTOL, err_msg=k)
    real, fake = evaluate.fvd_videos(dirs)
    assert real.shape == (2, 4, 224, 32, 3)
    assert [(c[0], c[2].shape) for c in calls] == [("videogpt", (2, 400))] * 2 + [("stylegan", (2, 1024))] * 2
    for j, variant in enumerate(("videogpt", "stylegan")):
        (_, got_real, f_real), (_, got_fake, f_fake) = calls[2 * j: 2 * j + 2]
        np.testing.assert_array_equal(got_real, real)
        np.testing.assert_array_equal(got_fake, fake)
        assert np.isfinite(row[f"fvd_{variant}"])
        assert row[f"fvd_{variant}"] == frechet_distance(*gaussian_stats(f_real), *gaussian_stats(f_fake))

    rows = list(csv.DictReader(open(os.path.join(out_dir, "evaluation.csv"))))
    assert len(rows) == 1 and float(rows[0]["ssim"]) == row["ssim"] and "lpips" not in rows[0]
    assert float(rows[0]["fvd_stylegan"]) == row["fvd_stylegan"]
    evaluate.main(argv + ["--no-lpips", "--max-videos", "1"])
    rows = list(csv.DictReader(open(os.path.join(out_dir, "evaluation.csv"))))
    assert len(rows) == 2 and rows[1]["n_videos"] == "1" and rows[1]["fvd_videogpt"] == ""
    np.testing.assert_allclose(float(rows[1]["mse"]), per_video[0]["mse"], rtol=RTOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            evaluate.main(["--path", str(gen_root), "--output", out_dir])
    # without the I3D file each FVD variant is skipped with its reason
    capsys.readouterr()
    row = evaluate.main(argv + ["--fvd", "--i3d-weights", str(tmp_path / "absent.npz")])
    assert "fvd_videogpt" not in row and "fvd_videogpt skipped: I3D weights not found" in capsys.readouterr().out
    # a file that is not a converted checkpoint raises, as the JAX scorer does
    np.savez(tmp_path / "bad.npz", weights=np.zeros(1))
    write_i3d_weights(str(tmp_path / "no_params.npz"), {"batch_stats": {}})
    for bad, match in (("bad.npz", "missing 'variables'"), ("no_params.npz", "lacks a 'params'")):
        with pytest.raises(ValueError, match=match):
            FVDScorer(str(tmp_path / bad))
