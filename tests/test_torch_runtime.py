"""The port's copies under the generation entry points, held to the JAX
package's originals on the same numpy inputs:

  * `camera/trajectory.py` (exact) on every `configs/demo/camera_pose_files`
    trajectory and on random poses, and `main/runtime.py::
    load_trajectory_txt` (exact) on those 12-column files and on a
    synthetic 19-column RealEstate10K file;
  * `utils/camera_trace.py` (exact), `data/single_image.py::
    get_batch_input` (exact), `utils/meta.py::apply_machine_config` (equal
    dicts), and the port's torchrun launcher and rank contract;
  * `utils/save_video.py::log_evaluation`: the JAX function's file set,
    `camera_data.npy` and `captions.txt` equal, `context_<j>.png` pixels
    equal to JAX's OpenCV PNGs; with OpenCV hidden `.npz` videos whose frames
    equal `to_uint8` of the input;
  * `data/image_io.py`: its PNG reader against PIL on PNGs of every filter
    type and colour layout, its writer read back by PIL;
  * the `.exp_meta.yaml` registry: the port's emitter and reader against
    PyYAML both ways, and `main/initialize.py` end to end;
  * `utils/profiling.py`: the seeding and timer as the JAX package's, the
    torch.profiler trace and its named regions.
"""

import glob
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from camc2v_tpu.camera import trajectory as JT
from camc2v_tpu.data.single_image import SingleImageForInference as JSingle
from camc2v_tpu.data.tokenizer import HashTokenizer as JHash
from camc2v_tpu.main.runtime import load_trajectory_txt as j_load_txt
from camc2v_tpu.utils import camera_trace as JCT
from camc2v_tpu.utils import meta as JM
from camc2v_tpu.utils import save_video as JSV

from camc2v_tpu_torch.camera import trajectory as TT
from camc2v_tpu_torch.data import image_io
from camc2v_tpu_torch.data.single_image import SingleImageForInference as TSingle
from camc2v_tpu_torch.data.tokenizer import HashTokenizer as THash
from camc2v_tpu_torch.main.runtime import load_trajectory_txt as t_load_txt
from camc2v_tpu_torch.utils import camera_trace as TCT
from camc2v_tpu_torch.utils import meta as TM
from camc2v_tpu_torch.utils import save_video as TSV

REPO = Path(__file__).resolve().parents[1]
POSE_FILES = sorted(glob.glob(str(REPO / "configs/demo/camera_pose_files/*.txt")))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _random_w2c(n=9, seed=0):
    """n w2c poses: random rotations (QR of a normal matrix) and translations."""
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        out[i, :3, :3] = q
        out[i, :3, 3] = rng.standard_normal(3)
    return out


# --------------------------------------------------------------- trajectory

def test_the_pose_files_are_sixteen_12_column_files():
    assert len(POSE_FILES) == 16
    assert all(np.loadtxt(p).shape[1] == 12 for p in POSE_FILES)


@pytest.mark.parametrize("source", [Path(p).stem for p in POSE_FILES] + ["random"])
def test_trajectory_copy_matches_jax(source):
    if source == "random":
        w2c = _random_w2c()
    else:
        path = str(REPO / "configs/demo/camera_pose_files" / f"{source}.txt")
        w2c = j_load_txt(path)
        _eq(t_load_txt(path), w2c)
    c2w = np.linalg.inv(w2c)
    for n in (16, 33):
        _eq(TT.camera_pose_lerp(c2w, n), JT.camera_pose_lerp(c2w, n))
        for a, b in ((None, None), (0.3, 0.7), (0.9, None), (None, 0.1)):
            _eq(TT.camera_pose_lerp_bezier(c2w, n, a, b), JT.camera_pose_lerp_bezier(c2w, n, a, b))
        _eq(TT.resample_poses_slerp(c2w, n), JT.resample_poses_slerp(c2w, n))
    t = np.linspace(0, 1, 11)
    _eq(TT.bezier_curve(t, 0.2, 0.6), JT.bezier_curve(t, 0.2, 0.6))
    for k in (1, 3):
        _eq(TT.extend_trajectory_autoregressive(c2w, k), JT.extend_trajectory_autoregressive(c2w, k))
    for mode in ("left", "right"):
        _eq(TT.relative_pose_to_index(c2w, mode, 1), JT.relative_pose_to_index(c2w, mode, 1))
    for i in range(len(c2w)):
        q = TT.matrix_to_quaternion(c2w[i, :3, :3])
        _eq(q, JT.matrix_to_quaternion(c2w[i, :3, :3]))
        _eq(TT.quaternion_to_matrix(q), JT.quaternion_to_matrix(q))
        _eq(TT.slerp(q, TT.matrix_to_quaternion(c2w[0, :3, :3]), 0.3),
            JT.slerp(q, JT.matrix_to_quaternion(c2w[0, :3, :3]), 0.3))


def test_load_trajectory_txt_realestate_rows(tmp_path):
    """19 columns (timestamp, fx fy cx cy, k1 k2, the 3x4 w2c) and a file of
    one line, as the JAX loader reads them; another width raises."""
    w2c = _random_w2c(5, seed=3)
    rows = [[i * 33366, 0.48, 0.85, 0.5, 0.5, 0.0, 0.0, *w2c[i, :3].reshape(-1)] for i in range(5)]
    np.savetxt(tmp_path / "re10k.txt", rows)
    np.savetxt(tmp_path / "one.txt", w2c[:1, :3].reshape(1, 12))
    for name in ("re10k.txt", "one.txt"):
        got = t_load_txt(str(tmp_path / name))
        _eq(got, j_load_txt(str(tmp_path / name)))
    np.testing.assert_allclose(t_load_txt(str(tmp_path / "re10k.txt")), w2c, rtol=0, atol=1e-12)
    np.savetxt(tmp_path / "bad.txt", np.zeros((2, 7)))
    with pytest.raises(ValueError, match="unrecognised trajectory format"):
        t_load_txt(str(tmp_path / "bad.txt"))


def test_camera_trace_copy_matches_jax(tmp_path):
    c2w = np.linalg.inv(j_load_txt(POSE_FILES[0]))
    _eq(TCT.trajectory_points(c2w), JCT.trajectory_points(c2w))
    _eq(TCT.trajectory_points(c2w[:1]), JCT.trajectory_points(c2w[:1]))
    _eq(TCT.frustum_points(c2w, 0.2), JCT.frustum_points(c2w, 0.2))
    for frustums in (True, False):
        TCT.export_camera_trace_obj(str(tmp_path / "t.obj"), c2w, with_frustums=frustums)
        JCT.export_camera_trace_obj(str(tmp_path / "j.obj"), c2w, with_frustums=frustums)
        assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()


def test_single_image_batch_matches_jax():
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    end = rng.integers(0, 256, (45, 70, 3), dtype=np.uint8)
    w2c = _random_w2c(6).astype(np.float32)
    intr = np.tile(np.array([[0.6, 0.9, 0.45, 0.55]]), (6, 1))
    cases = [dict(), dict(w2c=w2c, intrinsics_norm=intr, frame_stride=5, end_image=end)]
    for tokenizer in (None, "hash"):
        j = JSingle(6, (32, 48), JHash() if tokenizer else None)
        t = TSingle(6, (32, 48), THash() if tokenizer else None)
        for kw in cases:
            jb, tb = j.get_batch_input(image, "a room", **kw), t.get_batch_input(image, "a room", **kw)
            assert jb.keys() == tb.keys()
            for k in jb:
                if k == "caption":
                    assert tb[k] == jb[k]
                else:
                    _eq(tb[k], jb[k])


# --------------------------------------------------------------------- meta

def test_machine_config_matches_jax(monkeypatch):
    from camc2v_tpu_torch.config_yaml import load_yaml

    roots = {"val": {"data_dir": "/d/clips", "meta_path": "/d/meta"},
             "test": {"meta_list": "/d/list.txt", "caption_file": "/d/captions.json"}}
    for mod in (JM, TM):
        monkeypatch.setitem(mod.DATA_DIRECTORIES, "node", roots)
    for machine in ("node", "local", None, "unknown"):
        cfgs = [load_yaml(str(REPO / "configs/models/camcontexti2v_256.yaml")) for _ in range(2)]
        assert TM.apply_machine_config(cfgs[0], machine) == JM.apply_machine_config(cfgs[1], machine)
    # the hosts x cards of each setup (the port keeps only what its launcher reads)
    for machine in ("local", "x"):
        jax_setups = {k: {f: v[f] for f in ("num_hosts", "chips_per_host")} for k, v in JM.setups_for(machine).items()}
        assert TM.setups_for(machine) == jax_setups


def test_launcher_and_rank_contract(monkeypatch):
    one = TM.launcher_script("local", "default", "camc2v_tpu_torch.main.generate", ["--config", "c.yaml"])
    assert one.startswith("#!/bin/bash\nset -euo pipefail\n")
    assert "torchrun --nnodes 1 --nproc_per_node gpu --node_rank 0 --master_addr localhost" in one
    assert "-m camc2v_tpu_torch.main.generate --config c.yaml" in one and "JAX_" not in one
    monkeypatch.setitem(TM.SETUPS, "cluster", {"2x8": {"num_hosts": 2, "chips_per_host": 8}})
    two = TM.launcher_script("cluster", "2x8", "camc2v_tpu_torch.main.generate", [])
    assert "--nnodes 2 --nproc_per_node 8" in two and "${NODE_RANK:?" in two and "${MASTER_ADDR:?" in two
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert TM.process_from_env() == (0, 1, 0)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert TM.process_from_env() == (3, 4, 1)


# ------------------------------------------------------------------- media

def _cv2_png(path):
    import cv2

    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def test_log_evaluation_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    gen = rng.uniform(-1.2, 1.2, (4, 24, 32, 3)).astype(np.float32)
    gt = rng.uniform(-1, 1, (4, 24, 32, 3)).astype(np.float32)
    cam = rng.standard_normal((4, 19)).astype(np.float32)
    ctx = rng.uniform(-1, 1, (3, 24, 32, 3)).astype(np.float32)
    kw = dict(ground_truth=gt, camera_data=cam, caption="a room, with 'quotes'", context_frames=ctx, fps=6.0)
    _eq(TSV.to_uint8(gen), JSV.to_uint8(gen))
    jdir = Path(JSV.log_evaluation(str(tmp_path / "jax"), "v", gen, **kw))
    tdir = Path(TSV.log_evaluation(str(tmp_path / "port"), "v", gen, **kw))
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in ("camera_data.npy", "captions.txt"):
        assert (tdir / f).read_bytes() == (jdir / f).read_bytes()
    for j in range(3):
        _eq(_cv2_png(tdir / f"context_{j}.png"), _cv2_png(jdir / f"context_{j}.png"))
        _eq(image_io.read_image(str(jdir / f"context_{j}.png")), _cv2_png(jdir / f"context_{j}.png"))
    assert TSV.generated_exists(str(tdir))
    # a machine without OpenCV -> .npz videos
    monkeypatch.setitem(sys.modules, "cv2", None)
    ndir = Path(TSV.log_evaluation(str(tmp_path / "npz"), "v", gen, **kw))
    assert sorted(os.listdir(ndir)) == sorted(n.replace(".mp4", ".npz") for n in os.listdir(jdir))
    for name, video in (("generated", gen), ("ground_truth", gt)):
        data = np.load(ndir / f"{name}.npz")
        _eq(data["frames"], JSV.to_uint8(video))
        assert float(data["fps"]) == 6.0
    assert TSV.generated_exists(str(ndir)) and not TSV.generated_exists(str(tmp_path / "none"))
    videos = rng.uniform(-1, 1, (3, 2, 8, 8, 3)).astype(np.float32)
    path = TSV.save_grid(str(tmp_path / "grid"), videos)
    assert path.endswith(".npz")
    _eq(np.load(path)["frames"], JSV.to_uint8(np.concatenate(list(videos), axis=2)))


def _png_bytes(px: np.ndarray, ctype: int, filters) -> bytes:
    """A PNG of uint8 pixels `px` (H, W, C) whose row y uses filter type
    filters[y % len(filters)] (written out from the PNG specification)."""
    h, w, c = px.shape
    bpp, stride = c, w * c
    rows = px.reshape(h, stride).astype(np.int64)
    out = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            enc = cur
        elif f == 1:
            enc = cur - left
        elif f == 2:
            enc = cur - prev
        elif f == 3:
            enc = cur - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
            enc = cur - pred
        out += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_reader_matches_pil(tmp_path, ctype):
    from PIL import Image

    channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    px = np.random.default_rng(ctype).integers(0, 256, (13, 17, channels), dtype=np.uint8)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        path.write_bytes(_png_bytes(px, ctype, filters))
        want = np.asarray(Image.open(path).convert("RGB"))
        _eq(image_io.read_image(str(path)), want)


def test_png_writer_and_other_formats(tmp_path, monkeypatch):
    from PIL import Image

    rgb = np.random.default_rng(5).integers(0, 256, (21, 34, 3), dtype=np.uint8)
    image_io.write_png(str(tmp_path / "w.png"), rgb)
    _eq(np.asarray(Image.open(tmp_path / "w.png")), rgb)
    _eq(image_io.read_image(str(tmp_path / "w.png")), rgb)
    with pytest.raises(ValueError):
        image_io.write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))
    Image.fromarray(rgb).save(tmp_path / "p.png", optimize=True)  # PIL's own filters and compression
    _eq(image_io.read_image(str(tmp_path / "p.png")), rgb)
    Image.fromarray(rgb).save(tmp_path / "j.jpg")
    _eq(image_io.read_image(str(tmp_path / "j.jpg")), _cv2_png(tmp_path / "j.jpg"))  # through OpenCV
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match=r"\.png"):
        image_io.read_image(str(tmp_path / "j.jpg"))
    Image.fromarray(rgb).convert("P").save(tmp_path / "pal.png")  # a palette PNG needs OpenCV too
    with pytest.raises(ImportError, match=r"\.png"):
        image_io.read_image(str(tmp_path / "pal.png"))


# --------------------------------------------------------- experiment registry

META = {
    "host-1": {"run": {"config": "/abs/configs/models/camcontexti2v_256.yaml", "workdir": "/abs/results/run",
                       "created": "2026-10-17T23:40:06"}},
    "007": {"yes": {"a": "it's: #1", "b": "1e-4", "c": "0x1f", "d": "~", "e": "", "f": "[1, 2]", "g": "off"}},
    "empty": {},
}


def test_meta_yaml_both_ways():
    import yaml

    from camc2v_tpu_torch.config_yaml import dump_yaml, parse_yaml

    assert parse_yaml(yaml.safe_dump(META)) == META  # PyYAML's file, the port's reader
    assert yaml.safe_load(dump_yaml(META)) == META  # the port's file, PyYAML's reader
    assert parse_yaml(dump_yaml(META)) == META
    with pytest.raises(ValueError):
        dump_yaml({"a": "two\nlines"})


def test_initialize_entry_point(tmp_path, monkeypatch):
    """A registry written by PyYAML (as `00_initialize.py` writes it),
    extended by the port's `initialize` twice, read back by PyYAML."""
    import socket

    import yaml

    from camc2v_tpu_torch.main import initialize

    config = str(REPO / "configs/models/camcontexti2v_256.yaml")
    (tmp_path / "runs").mkdir()
    (tmp_path / "runs" / ".exp_meta.yaml").write_text(yaml.safe_dump({"other-host": {"old": {"config": "/x.yaml"}}}))
    monkeypatch.chdir(tmp_path)
    for name in ("first", "second"):
        assert initialize.main(["--config", config, "--name", name, "--logdir", "runs"]) == os.path.join("runs", name)
        for sub in ("configs", "checkpoints", "logs"):
            assert (tmp_path / "runs" / name / sub).is_dir()
        assert (tmp_path / "runs" / name / "configs/camcontexti2v_256.yaml").read_bytes() == Path(config).read_bytes()
    meta = yaml.safe_load((tmp_path / "runs" / ".exp_meta.yaml").read_text())
    assert meta["other-host"] == {"old": {"config": "/x.yaml"}} and sorted(meta[socket.gethostname()]) == ["first",
                                                                                                          "second"]
    entry = meta[socket.gethostname()]["second"]
    assert entry["config"] == config and entry["workdir"] == str(tmp_path / "runs" / "second")
    assert isinstance(entry["created"], str) and len(entry["created"]) == 19


def test_profiling_utils(tmp_path, monkeypatch):
    """`seed_everything` and `timed` as the JAX package's; `trace` writes a
    Chrome trace of the block, `annotate` names a region in it."""
    import random

    import torch

    from camc2v_tpu.utils import profiling as JP

    from camc2v_tpu_torch.utils import profiling as TP

    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    draws = []
    for mod in (JP, TP):
        assert mod.seed_everything(7, rank=2) == 9 and os.environ["PYTHONHASHSEED"] == "9"
        draws.append((random.random(), np.random.rand()))
    assert draws[0] == draws[1]
    sink = {}
    with TP.timed("block", sink):
        pass
    with TP.timed("block", sink):
        pass
    assert set(sink) == {"block"} and sink["block"] >= 0
    with TP.trace(str(tmp_path / "tr")):
        with TP.annotate("my_region"):
            torch.ones(8).sum()
    (trace,) = (tmp_path / "tr").iterdir()
    assert trace.suffix == ".json" and "my_region" in trace.read_text()
    with TP.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
