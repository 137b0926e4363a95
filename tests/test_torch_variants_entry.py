"""The port's entry-point rules of this slice, against the JAX package where
it has them:

  * the UNet's remat policies: `nn/unet3d.py::remat_policy` resolves every
    name and the `CAMC2V_REMAT_POLICY` override as the JAX `_remat_policy`
    does (None for 'none', the same ValueError for an unknown name, which
    the port also raises where a UNet is built), and each policy's saved
    ops are the ones its JAX counterpart names;
  * the evaluation functions default to the card and raise without CUDA;
  * `main.train --machine` substitutes the registry's data roots as
    `01_train.py` does: both CLIs' configs, captured where they create
    the run's workspace, are equal.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

REPO = Path(__file__).resolve().parents[1]


def _saved_ops():
    aten, kernel = torch.ops.aten, torch.ops.camc2v.kernel_forward.default
    dots = {aten.mm.default, aten.addmm.default}
    return {"dots": dots, "dots_batch": dots | {aten.bmm.default, aten.baddbmm.default}, "pallas": {kernel},
            "dots_pallas": dots | {kernel}}


@pytest.mark.parametrize("name", [None, "", "none", "dots", "dots_batch", "pallas", "dots_pallas"])
def test_remat_policy_resolution_matches_jax(name, monkeypatch):
    from camc2v_tpu.nn.unet3d import _remat_policy
    from camc2v_tpu_torch.nn.unet3d import remat_policy

    monkeypatch.delenv("CAMC2V_REMAT_POLICY", raising=False)
    got, want = remat_policy(name), _remat_policy(name)
    assert (got is None) == (want is None)
    assert got is None or set(got) == _saved_ops()[name]


@pytest.mark.parametrize("env,name", [("pallas", None), ("none", "dots"), ("dots_batch", "pallas")])
def test_remat_policy_environment_wins_as_in_jax(env, name, monkeypatch):
    from camc2v_tpu.nn.unet3d import _remat_policy
    from camc2v_tpu_torch.nn.unet3d import remat_policy

    monkeypatch.setenv("CAMC2V_REMAT_POLICY", env)
    assert (remat_policy(name) is None) == (_remat_policy(name) is None)
    assert remat_policy(name) is None or set(remat_policy(name)) == _saved_ops()[env]


def test_unknown_remat_policy_raises_as_in_jax(monkeypatch):
    from camc2v_tpu.nn.unet3d import _remat_policy
    from camc2v_tpu_torch import config as pc
    from camc2v_tpu_torch.nn.unet3d import UNetModel, remat_policy

    monkeypatch.delenv("CAMC2V_REMAT_POLICY", raising=False)
    with pytest.raises(ValueError) as jerr:
        _remat_policy("everything")
    with pytest.raises(ValueError) as terr:
        remat_policy("everything")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="unknown remat policy"):  # where the model is built
        UNetModel(pc.UNetConfig(model_channels=32, channel_mult=(1,), attention_resolutions=(),
                                remat_policy="everything"), dtype=torch.float32)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the card here")
def test_evaluation_defaults_to_the_card_and_raises_without_cuda(tmp_path):
    from camc2v_tpu_torch.eval import video_metrics as VM
    from camc2v_tpu_torch.eval.fvd import FVDScorer
    from camc2v_tpu_torch.main import evaluate

    frames = np.zeros((2, 16, 16, 3), np.uint8)
    calls = [lambda: VM.mse(frames, frames), lambda: VM.rmse(frames, frames), lambda: VM.psnr(frames, frames),
             lambda: VM.ssim(frames, frames), lambda: VM.lpips(frames, frames),
             lambda: VM.video_pair_metrics(frames, frames, with_lpips=False), lambda: FVDScorer(None),
             lambda: evaluate.run_extended([str(tmp_path)]), lambda: evaluate.run_fvd([str(tmp_path)], "videogpt", None)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available; pass device='cpu'"):
            call()
    assert VM.mse(frames, frames + 1, device="cpu") == 1.0


class _Captured(Exception):
    pass


def test_train_machine_substitutes_data_roots_as_the_jax_cli(tmp_path, monkeypatch):
    from test_torch_train_data import write_tree
    from test_torch_train_run import tiny_yaml

    import camc2v_tpu.main.harness as JH
    import camc2v_tpu.utils.meta as JM
    import camc2v_tpu_torch.main.harness as TH
    import camc2v_tpu_torch.utils.meta as TM
    from camc2v_tpu_torch.main import train

    config = tiny_yaml(tmp_path / "tiny.yaml", write_tree(tmp_path / "re10k", ["v0"]))
    roots = {split: {"data_dir": f"/data/{split}/clips", "meta_path": f"/data/{split}/meta",
                     "caption_file": f"/data/{split}/captions.json"} for split in ("train", "validation")}
    monkeypatch.setitem(JM.DATA_DIRECTORIES, "node", roots)
    monkeypatch.setitem(TM.DATA_DIRECTORIES, "node", roots)
    seen = {}

    def capture(side):
        def init_workspace(name, logdir, cfg):
            seen[side] = cfg
            raise _Captured
        return init_workspace

    monkeypatch.setattr(TH, "init_workspace", capture("port"))
    monkeypatch.setattr(JH, "init_workspace", capture("jax"))
    args = ["--config", config, "--machine", "node", "data.params.batch_size=3"]
    with pytest.raises(_Captured):
        train.main(args + ["--device", "cpu"])
    spec = importlib.util.spec_from_file_location("jax_train_cli", REPO / "01_train.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(sys, "argv", ["01_train.py"] + args)
    with pytest.raises(_Captured):
        cli.main()
    assert seen["port"]["data"] == seen["jax"]["data"]
    params = seen["port"]["data"]["params"]
    assert params["batch_size"] == 3
    for split, paths in roots.items():
        assert {k: params[split]["params"][k] for k in paths} == paths
