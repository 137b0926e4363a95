"""The port's copies of the training run's host modules against the JAX
package: the yaml reader against PyYAML, the configurations it builds
against `camc2v_tpu/config_yaml.py`'s, the RealEstate10K data path
(dataset, the collate that pads 1-4 context frames to 4, the loader) and the
tokenizer on the same synthetic clips and merges table, the resize without
OpenCV, and the logging sinks.

Everything here is exact (the same numpy arithmetic), except the resize
without OpenCV: PyTorch's bilinear in f32 against OpenCV's fixed point,
within one uint8 level.
"""

import dataclasses
import glob
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from camc2v_tpu_torch import config_yaml as tcy

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(str(Path(p).relative_to(REPO)) for p in glob.glob(str(REPO / "configs/**/*.yaml"), recursive=True))
DOTLIST_VALUES = ["1e-4", "1.0e-4", "0.5", "-3", "0x1f", "017", "yes", "off", "~", "null", "", "[1, 2]", "[]",
                  "{a: 1, b: [x, 'y z']}", "'it''s'", '"q\\tr"', "l2_log", "16-mixed", "data/x.txt", ".inf"]


def test_the_configs_are_the_five_yamls():
    assert len(YAMLS) == 5 and "configs/models/camcontexti2v_256.yaml" in YAMLS


@pytest.mark.parametrize("path", YAMLS + ["dotlist values"])
def test_yaml_reader_matches_safe_load(path):
    if path != "dotlist values":
        text = (REPO / path).read_text()
        assert tcy.parse_yaml(text) == yaml.safe_load(text)
        return
    for raw in DOTLIST_VALUES:
        want = yaml.safe_load(raw)
        got = tcy.parse_yaml(raw)
        assert got == want and type(got) is type(want), raw
    cfg = tcy.apply_dotlist({"a": {"b": 1}}, ["a.c.d=[1, 2]", "a.b=1e-4", "x=true"])
    assert cfg == {"a": {"b": "1e-4", "c": {"d": [1, 2]}}, "x": True}
    for bad in ("a: *anchor", "a: !!str 1", "a: |\n  text", "<<: {a: 1}", "a:\n- 1"):
        with pytest.raises(tcy.YamlSubsetError):
            tcy.parse_yaml(bad)


@pytest.mark.parametrize("path", YAMLS)
def test_configs_match_the_jax_bridge(path):
    """The port's model and train configurations of every yaml, field by
    field against the JAX bridge's, and the port's model class of each
    (MotionCtrl and CameraCtrl included) the JAX bridge's."""
    from camc2v_tpu import config_yaml as jcy
    from test_torch_port_modules import port_config

    cfg = tcy.load_yaml(str(REPO / path))
    jmodel, jpre = jcy.build_model_from_config(jcy.load_yaml(str(REPO / path)))
    cls_name, tconfig = tcy.model_config_from_yaml(cfg)
    assert type(tconfig).__name__ == type(jmodel.config).__name__
    assert tconfig == port_config(jmodel.config)
    jtrain = jcy.build_train_config(jcy.load_yaml(str(REPO / path)))
    ttrain = tcy.build_train_config(cfg)
    for f in dataclasses.fields(ttrain):
        jv = getattr(jtrain, f.name)
        assert getattr(ttrain, f.name) == (float(jv) if isinstance(getattr(ttrain, f.name), float) else jv), f.name
    assert not jtrain.shard_params
    assert tcy.model_class(cls_name).__name__ == type(jmodel).__name__
    assert jpre == cfg["model"].get("pretrained_checkpoint")


# --------------------------------------------------------------- data path

N_FRAMES, H_SRC, W_SRC = 24, 36, 64


def write_tree(root: Path, names, seed=0) -> dict:
    """Synthetic RealEstate10K clips (.npz) with pose files of a moving
    camera and captions; returns the dataset's path arguments."""
    from camc2v_tpu_torch.data.video_io import write_video

    rng = np.random.default_rng(seed)
    (root / "clips").mkdir(parents=True, exist_ok=True)
    (root / "meta").mkdir(exist_ok=True)
    for name in names:
        write_video(str(root / "clips" / f"{name}.npz"),
                    rng.integers(0, 255, (N_FRAMES, H_SRC, W_SRC, 3), dtype=np.uint8), fps=30.0)
        with open(root / "meta" / f"{name}.txt", "w") as f:
            f.write("http://example.com/video\n")
            for i in range(N_FRAMES):
                pose = np.hstack([np.eye(3), [[0.1 * i], [0.02 * i], [-0.05 * i]]]).reshape(-1)
                f.write(" ".join(f"{v:.6f}" for v in [i * 1000, 0.9, 1.6, 0.5, 0.5, 0.0, 0.0, *pose]) + "\n")
    (root / "list.txt").write_text("\n".join(names) + "\n")
    (root / "captions.json").write_text(json.dumps({f"{n}.mp4": [f"a room {n}"] for n in names}))
    return dict(data_dir=str(root / "clips"), meta_path=str(root / "meta"), meta_list=str(root / "list.txt"),
                caption_file=str(root / "captions.json"), video_suffix=".npz")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("re10k"), [f"vid{i}" for i in range(5)])


def _datasets(tree, **kw):
    from camc2v_tpu.data import realestate10k as jre
    from camc2v_tpu.data.tokenizer import HashTokenizer as JHash

    from camc2v_tpu_torch.data import realestate10k as tre
    from camc2v_tpu_torch.data.tokenizer import HashTokenizer as THash

    args = dict(tree, video_length=4, resolution=[32, 32], frame_stride=[1, 4], additional_cond_frames="random_full",
                num_additional_cond_frames=[1, 4], pad_context_frames_to=4, seed=3, **kw)
    return jre.RealEstate10K(tokenizer=JHash(), **args), tre.RealEstate10K(tokenizer=THash(), **args), jre, tre


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or np.isscalar(a[k]):
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
            assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k
        else:
            assert a[k] == b[k], k


def test_realestate10k_collate_and_loader_match_jax(tree):
    """Samples, the batch-consistent context count padded to 4 with
    `cond_frames_valid`, and the loader's batches, from the same seed."""
    jds, tds, jre, tre = _datasets(tree)
    for i in range(len(jds)):
        _assert_same(jds[i], tds[i])
    for _ in range(3):
        jb = jds.collate([jds[i] for i in (0, 1)])
        tb = tds.collate([tds[i] for i in (0, 1)])
        _assert_same(jb, tb)
        assert tb["cond_frames"].shape == (2, 4, 32, 32, 3) and tb["cond_frames_valid"].shape == (2, 4)
        n = int(tb["cond_frames_valid"][0].sum())
        assert 1 <= n <= 4 and (tb["cond_frames"][:, n:] == 0).all()
        np.testing.assert_array_equal(tb["RT_cond"][:, n:], np.broadcast_to(np.eye(4), (2, 4 - n, 4, 4)))
    jds, tds, jre, tre = _datasets(tree, max_samples=4)
    jl = jre.DataLoader(jds, batch_size=2, shuffle=True, seed=5)
    tl = tre.DataLoader(tds, batch_size=2, shuffle=True, seed=5)
    assert len(tl) == len(jl) == 2
    for jb, tb in zip(list(jl) + list(jl), list(tl) + list(tl)):
        _assert_same(jb, tb)
    threaded = list(tre.DataLoader(tds, batch_size=2, num_workers=2))
    assert [b["video"].shape for b in threaded] == [(2, 4, 32, 32, 3)] * 2


def test_tokenizer_copy_matches_jax(tmp_path):
    from camc2v_tpu.data import tokenizer as jtok

    from camc2v_tpu_torch.data import tokenizer as ttok

    merges = tmp_path / "merges.txt"
    merges.write_text("\n".join(["#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "w o", "r l", "wo rl",
                                 "worl d</w>"]) + "\n")
    texts = ["hello world", "Hello,   WORLD &amp; a room!", "x " * 100, ""]
    for ctx in (8, 77):
        j, t = jtok.SimpleTokenizer(str(merges), ctx), ttok.SimpleTokenizer(str(merges), ctx)
        assert t.vocab_size == j.vocab_size
        for text in texts:
            np.testing.assert_array_equal(t(text), j(text))
        np.testing.assert_array_equal(t(texts), j(texts))
        np.testing.assert_array_equal(ttok.HashTokenizer(context_length=ctx)(texts),
                                      jtok.HashTokenizer(context_length=ctx)(texts))
    assert type(ttok.default_tokenizer(str(merges))).__name__ == "SimpleTokenizer"
    assert type(ttok.default_tokenizer(None)).__name__ == "HashTokenizer"


def test_resize_without_opencv_within_one_level(monkeypatch):
    """The PyTorch bilinear the data path takes without OpenCV, against
    OpenCV's INTER_LINEAR at the flagship's 360x640 -> 256x455 resize."""
    from camc2v_tpu_torch.data import realestate10k as tre

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (2, 360, 640, 3), dtype=np.uint8)
    frames[1] = (127 + 120 * np.sin(np.arange(640) / 17.0))[None, :, None].astype(np.uint8)
    want = tre._resize_bilinear(frames, 256, 455)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now raises ImportError
    got = tre._resize_bilinear(frames, 256, 455)
    assert got.shape == want.shape == (2, 256, 455, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    intr = np.tile([[0.48, 0.85, 0.5, 0.5]], (2, 1))
    crop, K = tre.resize_center_crop(frames, 256, 256, intr)
    assert crop.shape == (2, 256, 256, 3) and np.allclose(K[0], [[0.48 * 455, 0, 128], [0, 0.85 * 256, 128],
                                                                  [0, 0, 1]])


def test_sinks(tmp_path, monkeypatch):
    """CSV rows appended under one header by a resumed run; a sink whose
    package is absent raises an ImportError naming it, which build_sinks
    turns into a warning."""
    from camc2v_tpu_torch.main import loggers as L

    L.CSVSink(str(tmp_path)).log_scalars(1, {"loss": 0.5, "grad_norm": 1.0})
    L.CSVSink(str(tmp_path)).log_scalars(2, {"grad_norm": 2.0, "loss": 0.25})
    assert (tmp_path / "metrics.csv").read_text().splitlines() == ["step,grad_norm,loss", "1,1,0.5", "2,2,0.25"]
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    for cls, name in ((L.TensorBoardSink, "tensorboard"), (L.WandbSink, "wandb")):
        with pytest.raises(ImportError, match=name):
            cls(str(tmp_path))
    sinks = L.build_sinks(["csv", "tensorboard", {"target": "WandbLogger"}], str(tmp_path / "b"))
    assert [type(s).__name__ for s in sinks] == ["CSVSink"]


def test_checkpoint_files_and_max_to_keep(tmp_path):
    """Step-tagged files, the latest step, pruning to `max_to_keep`."""
    from camc2v_tpu_torch.parallel import trainer as TR
    from camc2v_tpu_torch.utils import checkpoint as CK

    model = torch.nn.ModuleDict({"adaptor": torch.nn.Linear(3, 2)})
    state = TR.init_train_state(TR.TrainConfig(trainable_patterns=(r"^adaptor/",), use_ema=True), model)
    assert CK.latest_step(str(tmp_path / "none")) is None
    for step in (2, 4, 6):
        state.step = step
        CK.save_checkpoint(str(tmp_path), state, step, max_to_keep=2)
    assert CK.saved_steps(str(tmp_path)) == [4, 6] and CK.latest_step(str(tmp_path)) == 6
    with torch.no_grad():
        state.params[0].add_(1.0)
        state.ema_params["adaptor.weight"].add_(1.0)
    CK.restore_checkpoint(str(tmp_path), state, step=4)
    assert state.step == 4
    saved = torch.load(CK.checkpoint_path(str(tmp_path), 4), weights_only=True)
    assert torch.equal(state.params[0], saved["params"]["adaptor.weight"])
    assert torch.equal(state.ema_params["adaptor.weight"], saved["ema_params"]["adaptor.weight"])
