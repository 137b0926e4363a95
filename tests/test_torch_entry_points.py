"""The port's generation entry points against the JAX package's.

With stub models on both sides, which record the batch and keywords handed
to `sample` and answer with the same numbers, no UNet run:
  * `main/runtime.py::Image2Video.get_image` (2 chunks, loop, Bézier, trace
    ratio, context frames) and `main/harness.py::generate_videos` over the
    same synthetic `.npz` tree hand `sample` the tensors the JAX functions
    hand it, within 1e-6, and the same keywords; the chunk loop feeds the
    last generated frame on; `--continue` skips; under RANK=1 WORLD_SIZE=2
    `main/generate.py` writes only that shard's videos.
Then one TINY run each of `main.generate.main` (its `--ckpt` a 1-step
`main.train` run's checkpoint directory) and `main.visualize.main` on the
CPU with 2 DDIM steps: the videos written equal `model.sample` of the
trained model in process (of the seeded model for the demo) on the same
batch and generator; without `--device cpu` each raises here.
"""

import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_modules import one_torch_thread  # noqa: F401
from test_torch_train_data import write_tree
from test_torch_train_run import tiny_yaml

from camc2v_tpu_torch.main import generate, harness, runtime, visualize
from camc2v_tpu_torch.utils.save_video import to_uint8

REPO = Path(__file__).resolve().parents[1]
POSES = REPO / "configs/demo/camera_poses.json"


def _answer(video: np.ndarray, call: int) -> np.ndarray:
    """The stubs' `sample` output for a batch's video on their call-th
    call: the input moved by seeded noise, f32 (B, T, H, W, 3)."""
    rng = np.random.default_rng(100 + call)
    return (0.8 * video + 0.3 * rng.uniform(-1, 1, video.shape)).astype(np.float32)


class _TextConfig:
    context_length, vocab_size = 77, 49408


class _Config:
    clip_text = _TextConfig()


class JaxStub:
    """`model.sample(params, batch, rng, **kw)` of the JAX package."""

    config = _Config()

    def __init__(self):
        self.calls = []

    def sample(self, params, batch, rng, **kw):
        import jax.numpy as jnp

        self.calls.append(({k: np.asarray(v) for k, v in batch.items()}, kw))
        return jnp.asarray(_answer(np.asarray(batch["video"]), len(self.calls) - 1))


class TorchStub(torch.nn.Module):
    """`model.sample(batch, generator=..., **kw)` of the port."""

    config = _Config()

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))  # the device
        self.calls = []

    def sample(self, batch, *, generator, **kw):
        self.calls.append(({k: v.numpy() for k, v in batch.items()}, dict(kw, seed=generator.initial_seed())))
        return torch.from_numpy(_answer(batch["video"].numpy(), len(self.calls) - 1))


def _same_calls(jax_calls, port_calls, seeds):
    assert len(port_calls) == len(jax_calls) == len(seeds)
    for (jb, jkw), (tb, tkw), seed in zip(jax_calls, port_calls, seeds):
        assert tb.keys() == jb.keys(), (sorted(tb), sorted(jb))
        for k in jb:
            assert tb[k].shape == jb[k].shape, k
            if np.issubdtype(jb[k].dtype, np.floating):
                np.testing.assert_allclose(tb[k], jb[k], rtol=0, atol=1e-6, err_msg=k)
            else:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tkw.pop("seed") == seed and tkw == jkw


def npz_videos(monkeypatch):
    """The port writes `.npz` videos, as on a machine without OpenCV, while the
    resize keeps OpenCV (the JAX package's call)."""
    from camc2v_tpu_torch.utils import save_video

    monkeypatch.setattr(save_video, "video_file", lambda stem: stem + ".npz")


@pytest.fixture
def no_jax_cache(monkeypatch):
    monkeypatch.setenv("CAMC2V_COMPILE_CACHE", "0")  # the JAX functions' compile cache, kept off the disk


CASES = {
    "two chunks": dict(trajectory="zoom in", num_chunks=2),
    "loop": dict(trajectory="orbit left", loop=True),
    "bezier + trace ratio": dict(trajectory="pan right", bezier_coef_a=0.3, bezier_coef_b=0.8,
                                 trace_extract_ratio=0.5, num_chunks=2),
    "context frames, no trajectory": dict(context=True, camera_cfg=1.5, trace_scale_factor=2.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_get_image_hands_sample_what_jax_does(case, tmp_path, monkeypatch, no_jax_cache):
    from camc2v_tpu.main import runtime as jrt

    kw = dict(CASES[case])
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    if kw.pop("context", False):
        kw.update(context_frames=rng.uniform(-1, 1, (2, 24, 32, 3)).astype(np.float32),
                  context_w2c=np.tile(np.eye(4), (2, 1, 1)) + 0.01)
    if "trajectory" in kw:
        kw["trajectory"] = jrt.load_trajectory_txt(str(REPO / f"configs/demo/camera_pose_files/{kw['trajectory']}.txt"))
    engines = {}
    for name, mod, stub in (("jax", jrt, JaxStub()), ("port", runtime, TorchStub())):
        extra = {} if name == "jax" else dict(device="cpu")
        engine = mod.Image2Video({"m": "unused.yaml"}, result_dir=str(tmp_path / name), video_length=4,
                                 resolution=(24, 32), seed=7, **extra)
        engine._models["m"] = (stub, None) if name == "jax" else stub
        engines[name] = engine, stub
    jpath = engines["jax"][0].get_image("m", image, "a red room", save_name="v", ddim_steps=3, **kw)
    npz_videos(monkeypatch)
    tpath = engines["port"][0].get_image("m", image, "a red room", save_name="v", ddim_steps=3, **kw)
    chunks = kw.get("num_chunks", 1)
    calls = engines["port"][1].calls
    _same_calls(engines["jax"][1].calls, calls, [7 + k for k in range(chunks)])
    outs = [_answer(b["video"], k)[0] for k, (b, _) in enumerate(calls)]
    for k in range(1, chunks):  # the chunk loop: the last generated frame conditions the next chunk
        assert np.array_equal(calls[k][0]["video"][0], np.broadcast_to(outs[k - 1][-1], (4, 24, 32, 3)))
    assert jpath.endswith("v.mp4") and tpath.endswith("v.npz")
    frames = np.load(tpath)["frames"]
    assert frames.shape == (4 + 3 * (chunks - 1), 24, 32, 3)
    np.testing.assert_array_equal(frames, to_uint8(np.concatenate([outs[0]] + [o[1:] for o in outs[1:]])))


def _loaders(tree, batch_size=2, **kw):
    """The JAX and the port's RealEstate10K loaders over one tree, seeded
    alike (so both draw the same strides and contexts)."""
    from camc2v_tpu.data import realestate10k as jre
    from camc2v_tpu.data.tokenizer import HashTokenizer as JHash

    from camc2v_tpu_torch.data import realestate10k as tre
    from camc2v_tpu_torch.data.tokenizer import HashTokenizer as THash

    args = dict(tree, video_length=4, resolution=[32, 32], frame_stride=[1, 4], additional_cond_frames="random_back",
                num_additional_cond_frames=[1, 4], pad_context_frames_to=4, seed=3)
    return (jre.DataLoader(jre.RealEstate10K(tokenizer=JHash(), **args), batch_size, drop_last=False, **kw),
            tre.DataLoader(tre.RealEstate10K(tokenizer=THash(), **args), batch_size, drop_last=False, **kw))


def test_generate_videos_hands_sample_what_jax_does(tmp_path, monkeypatch, no_jax_cache):
    from camc2v_tpu.main.harness import generate_videos as j_generate

    from camc2v_tpu_torch.data.image_io import read_image

    tree = write_tree(tmp_path / "re10k", [f"v{i}" for i in range(5)])
    jdl, tdl = _loaders(tree)
    kw = dict(sample_kwargs=dict(ddim_steps=3, guidance_scale=7.5, camera_cfg=1.5), max_batches=2, seed=11)
    jstub, tstub = JaxStub(), TorchStub()
    jdirs = j_generate(jstub, None, jdl, str(tmp_path / "jax"), **kw)
    npz_videos(monkeypatch)
    timings = []
    handler = logging.Handler()
    handler.emit = lambda record: timings.append(record.timing) if hasattr(record, "timing") else None
    level = harness.logger.level
    harness.logger.addHandler(handler)
    harness.logger.setLevel(logging.INFO)
    try:
        tdirs = harness.generate_videos(tstub, tdl, str(tmp_path / "port"), **kw)
    finally:
        harness.logger.removeHandler(handler)
        harness.logger.setLevel(level)
    _same_calls(jstub.calls, tstub.calls, [11, 12])
    assert [os.path.basename(d) for d in tdirs] == [os.path.basename(d) for d in jdirs] == ["v0", "v1", "v2", "v3"]
    assert [t["videos"] for t in timings] == [2, 2]
    for jd, td in zip(jdirs, tdirs):
        assert sorted(os.listdir(td)) == sorted(f.replace(".mp4", ".npz") for f in os.listdir(jd))
        for f in ("camera_data.npy", "captions.txt"):
            assert Path(td, f).read_bytes() == Path(jd, f).read_bytes()
        for f in (f for f in os.listdir(jd) if f.endswith(".png")):
            np.testing.assert_array_equal(read_image(os.path.join(td, f)), read_image(os.path.join(jd, f)))
    for j, d in enumerate(tdirs):
        b, i = divmod(j, 2)
        np.testing.assert_array_equal(np.load(os.path.join(d, "generated.npz"))["frames"],
                                      to_uint8(_answer(tstub.calls[b][0]["video"], b)[i]))
    # --continue: the existing batches are skipped, a batch with a missing video is generated again
    _, tdl = _loaders(tree)
    assert harness.generate_videos(tstub, tdl, str(tmp_path / "port"), skip_existing=True, **kw) == []
    assert len(tstub.calls) == 2
    os.remove(os.path.join(tdirs[3], "generated.npz"))
    _, tdl = _loaders(tree)
    again = harness.generate_videos(tstub, tdl, str(tmp_path / "port"), skip_existing=True, **kw)
    assert [os.path.basename(d) for d in again] == ["v2", "v3"] and len(tstub.calls) == 3
    with pytest.raises(NotImplementedError, match="item 6"):
        harness.generate_videos(tstub, tdl, str(tmp_path / "port"), mesh=object())


def test_generate_cli_writes_only_its_shard(tmp_path, monkeypatch):
    tree = write_tree(tmp_path / "re10k", [f"v{i}" for i in range(4)])
    config = tiny_yaml(tmp_path / "tiny.yaml", tree)
    stub = TorchStub()
    monkeypatch.setattr(generate, "load_model", lambda *a: stub)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    argv = ["--config", config, "--device", "cpu", "--out", str(tmp_path / "gen"), "data.params.num_workers=0"]
    written = generate.main(argv)
    assert sorted(os.listdir(tmp_path / "gen")) == ["v1", "v3"] and len(written) == 2 and len(stub.calls) == 1
    assert generate.main(argv + ["--continue"]) == [] and len(stub.calls) == 1
    with pytest.raises(NotImplementedError, match="item 6"):
        generate.main(argv + ["--shard-data"])
    launcher = tmp_path / "launch.sh"
    assert generate.main(argv + ["--emit-launcher", str(launcher)]) == []
    text = launcher.read_text()
    assert "torchrun --nnodes 1" in text and "-m camc2v_tpu_torch.main.generate --config" in text
    assert "--emit-launcher" not in text and str(launcher) not in text


def _recording(monkeypatch):
    """Record the (model, batch, generator seed, keywords) of every
    `DynamiCrafter.sample` call; the call itself goes through."""
    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter

    calls, sample = [], DynamiCrafter.sample

    def record(self, batch, *, generator=None, **kw):
        calls.append((self, {k: v.clone() for k, v in batch.items()}, generator.initial_seed(), kw))
        return sample(self, batch, generator=generator, **kw)

    monkeypatch.setattr(DynamiCrafter, "sample", record)
    return calls, sample


def _tiny_config(tmp_path, monkeypatch) -> str:
    """The flagship yaml cut to TINY over a 4-clip tree, on the card's
    machine's terms (no OpenCV), outside torchrun."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return tiny_yaml(tmp_path / "tiny.yaml", write_tree(tmp_path / "re10k", [f"v{i}" for i in range(4)]))


def test_tiny_generate_run_from_a_training_checkpoint(tmp_path, monkeypatch):
    from camc2v_tpu_torch.main import train
    from camc2v_tpu_torch.utils.weights import cast_for_inference

    config = _tiny_config(tmp_path, monkeypatch)
    # trained from seed 5, generated with the CLI's default seed: the base comes from the checkpoint's record
    trainer, state = train.main(["--config", config, "--device", "cpu", "--logdir", str(tmp_path / "runs"),
                                 "--name", "tiny", "--max_steps", "1", "--seed", "5", "data.params.num_workers=0",
                                 "lightning.logger=csv"])
    assert state.step == 1
    argv = ["--config", config, "--out", str(tmp_path / "gen"), "--ddim-steps", "2", "--num-videos", "1",
            "--ckpt", str(tmp_path / "runs/tiny/checkpoints"), "data.params.num_workers=0"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(argv)
    calls, sample = _recording(monkeypatch)
    written = generate.main(argv + ["--device", "cpu"])
    assert len(written) == 2 and len(calls) == 1
    model, batch, seed, kw = calls[0]
    assert seed == 20240101 and kw["ddim_steps"] == 2 and kw["camera_cfg"] == 1.0
    trained = cast_for_inference(trainer.model.eval(), torch.bfloat16)  # the trained model, in process
    assert model is not trained
    want = sample(trained, batch, generator=torch.Generator().manual_seed(seed), **kw).float().numpy()
    for j, d in enumerate(written):
        np.testing.assert_array_equal(np.load(os.path.join(d, "generated.npz"))["frames"], to_uint8(want[j]))
    # a saved parameter the model lacks is an error
    from camc2v_tpu_torch.config_yaml import load_yaml
    from camc2v_tpu_torch.main.harness import setup_logger
    from camc2v_tpu_torch.utils import checkpoint as CK

    ckpt_dir = str(tmp_path / "runs/tiny/checkpoints")
    base = CK.read_base(ckpt_dir)
    assert base["seed"] == 5 and base["pretrained"] is None
    step, saved = CK.load_saved(ckpt_dir)
    saved["params"]["adaptor.not_a_parameter"] = torch.zeros(1)
    bad = str(tmp_path / "bad")
    os.makedirs(bad)
    torch.save(saved, CK.checkpoint_path(bad, step))
    with pytest.raises(FileNotFoundError, match="base.json"):
        generate.load_model(load_yaml(config), bad, "cpu", 0, setup_logger(None))
    CK.write_base(bad, base)
    with pytest.raises(ValueError, match="adaptor.not_a_parameter"):
        generate.load_model(load_yaml(config), bad, "cpu", 0, setup_logger(None))
    # a base that cannot be made again is an error, not other weights
    CK.write_base(bad, dict(base, digest="0" * 64))
    with pytest.raises(ValueError, match="other weights"):
        generate.load_model(load_yaml(config), bad, "cpu", 0, setup_logger(None))
    CK.write_base(bad, dict(base, pretrained=str(tmp_path / "gone.pt")))
    with pytest.raises(FileNotFoundError, match="gone.pt"):
        generate.load_model(load_yaml(config), bad, "cpu", 0, setup_logger(None))
    # resuming the training from another seed would lay the masters over other weights
    with pytest.raises(ValueError, match="other weights"):
        train.main(["--config", config, "--device", "cpu", "--logdir", str(tmp_path / "runs"), "--name", "tiny",
                    "--max_steps", "1", "--continue", "data.params.num_workers=0", "lightning.logger=csv"])


def test_cli_makes_its_local_rank_the_current_device(tmp_path, monkeypatch):
    """Under torchrun, rank r's model and kernels go to cuda:LOCAL_RANK, which
    must also be the current device (the kernels launch on its stream)."""
    from camc2v_tpu_torch.main.runtime import Image2Video

    current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: current.append(torch.device(d)))

    class Built(Exception):
        pass

    def stop(*a, **k):
        raise Built

    monkeypatch.setattr(generate, "load_model", stop)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    config = tiny_yaml(tmp_path / "tiny.yaml", write_tree(tmp_path / "re10k", ["v0", "v1"]))
    with pytest.raises(Built):
        generate.main(["--config", config, "--out", str(tmp_path / "gen")])
    assert current == [torch.device("cuda:1")]
    monkeypatch.setattr("camc2v_tpu_torch.config_yaml.build_model_from_config", stop)
    engine = Image2Video({"tiny": config}, result_dir=str(tmp_path / "demo"), device="cuda:3")
    with pytest.raises(Built):
        engine._get_model("tiny")
    assert current == [torch.device("cuda:1"), torch.device("cuda:3")]


def test_tiny_visualize_run(tmp_path, monkeypatch):
    from camc2v_tpu_torch.config_yaml import build_model_from_config, load_yaml
    from camc2v_tpu_torch.data.image_io import write_png
    from camc2v_tpu_torch.utils.weights import cast_for_inference

    config = _tiny_config(tmp_path, monkeypatch)
    write_png(str(tmp_path / "in.png"), np.random.default_rng(0).integers(0, 256, (40, 52, 3), dtype=np.uint8))
    argv = ["--models", f"tiny={config}", "--image", str(tmp_path / "in.png"), "--prompt", "a room",
            "--trajectory-name", "zoom in", "--poses-json", str(POSES), "--chunks", "2", "--video-length", "4",
            "--resolution", "32", "32", "--ddim-steps", "2", "--out", str(tmp_path / "demo")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        visualize.main(argv)
    calls, sample = _recording(monkeypatch)
    path = visualize.main(argv + ["--device", "cpu"])
    assert len(calls) == 2 and [c[2] for c in calls] == [123, 124]
    seeded, _ = build_model_from_config(load_yaml(config), device="cpu", seed=123)
    seeded = cast_for_inference(seeded.eval(), torch.bfloat16)
    outs = [sample(seeded, b, generator=torch.Generator().manual_seed(s), **kw).float()[0] for _, b, s, kw in calls]
    assert torch.equal(calls[1][1]["video"][0], outs[0][-1].expand(4, -1, -1, -1))
    frames = np.load(path)["frames"]
    assert path.endswith(".npz") and frames.shape == (7, 32, 32, 3)
    np.testing.assert_array_equal(frames, to_uint8(torch.cat([outs[0], outs[1][1:]]).numpy()))
