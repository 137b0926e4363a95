"""The port's import of the reference `.pt` checkpoint against the JAX package's.

No reference checkpoint is in the repo, so the state dicts are fabricated
with the reference's names: `reference_key` writes, for every parameter of a
port model, a reference key that the importer's forward map sends to it
(the inverse of `map_reference_key`'s block map and rules), and
`reference_state_dict` the parameter's values in the reference's layouts
(the JAX package's `_inverse_transform`; the UNet's `init_attn` projections
as the reference's Conv1d(k=1) kernels). With every parameter of a TINY
CamContextI2V covered, the port's `import_state_dict` is held bit for bit
to the JAX `import_state_dict` followed by `load_jax_params`.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import plain_tiny, seeded_params_for  # noqa: E402
from test_torch_port_modules import flat, one_torch_thread, port_config  # noqa: E402,F401

from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V  # noqa: E402
from camc2v_tpu_torch.utils import torch_import as PI  # noqa: E402
from camc2v_tpu_torch.utils.weights import load_jax_params  # noqa: E402

PREFIX = {"unet": "model.diffusion_model.", "vae": "first_stage_model.", "clip_text": "cond_stage_model.model.",
          "clip_vision": "embedder.model.visual.", "image_proj": "image_proj_model.", "pose_encoder": "pose_encoder.",
          "adaptor": "multi_cond_latent_adaptor.", "zero_conv": "multi_cond_in_projection."}
# the inverse of the forward rules, on the path below a component (and below
# the UNet block), '/'-separated, leaf already 'weight' / 'bias'
UNET_INV = [(r"^in_norm/", "in_layers/0/"), (r"^in_conv/", "in_layers/2/"), (r"^emb_proj/", "emb_layers/1/"),
            (r"^out_norm/", "out_layers/0/"), (r"^out_conv/", "out_layers/3/"), (r"^skip/", "skip_connection/"),
            (r"^temporal_conv/conv1_norm/", "temopral_conv/conv1/0/"),
            (r"^temporal_conv/conv1_conv/", "temopral_conv/conv1/2/"),
            (r"^temporal_conv/conv([234])_norm/", r"temopral_conv/conv\1/0/"),
            (r"^temporal_conv/conv([234])_conv/", r"temopral_conv/conv\1/3/"),
            (r"^block_(\d+)/", r"transformer_blocks/\1/"), (r"/attn(\d)/to_out/", r"/attn\1/to_out/0/"),
            (r"/ff/geglu/proj/", "/ff/net/0/proj/"), (r"/ff/fc2/", "/ff/net/2/"),
            (r"/epipolar_attn/to_out/", "/epipolar_attn/to_out/0/"), (r"^fc1/", "0/"), (r"^fc2/", "2/")]
VAE_INV = [(r"down_(\d+)_block_(\d+)/", r"down/\1/block/\2/"), (r"down_(\d+)_downsample/", r"down/\1/downsample/conv/"),
           (r"down_(\d+)_attn_(\d+)/", r"down/\1/attn/\2/"), (r"up_(\d+)_block_(\d+)/", r"up/\1/block/\2/"),
           (r"up_(\d+)_upsample/", r"up/\1/upsample/conv/"), (r"up_(\d+)_attn_(\d+)/", r"up/\1/attn/\2/"),
           (r"mid_block_([12])/", r"mid/block_\1/"), (r"mid_attn_1/", "mid/attn_1/")]
CLIP_INV = [(r"^resblock_(\d+)/", r"transformer/resblocks/\1/"), (r"/attn/in_proj/(weight|bias)$", r"/attn/in_proj_\1")]
RESAMPLER_INV = [(r"^attn_(\d+)/to_out/", r"layers/\1/0/to_out/0/"), (r"^attn_(\d+)/", r"layers/\1/0/"),
                 (r"^ff_(\d+)/norm/", r"layers/\1/1/0/"), (r"^ff_(\d+)/fc1/", r"layers/\1/1/1/"),
                 (r"^ff_(\d+)/fc2/", r"layers/\1/1/3/"), (r"^temb_fc1/", "timestep_embedding_func/0/"),
                 (r"^temb_fc2/", "timestep_embedding_func/2/")]
POSE_INV = [(r"^conv_in/", "encoder_conv_in/"), (r"^level(\d+)_res(\d+)/down_conv/", r"encoder_down_conv_blocks/\1/\2/down_opt/op/"),
            (r"^level(\d+)_res(\d+)/", r"encoder_down_conv_blocks/\1/\2/"),
            (r"^level(\d+)_attn(\d+)/to_out/", r"encoder_down_attention_blocks/\1/\2/attention_blocks/0/to_out/0/"),
            (r"^level(\d+)_attn(\d+)/to_(q|k|v)/", r"encoder_down_attention_blocks/\1/\2/attention_blocks/0/to_\3/"),
            (r"^level(\d+)_attn(\d+)/norm/", r"encoder_down_attention_blocks/\1/\2/norms/0/"),
            (r"^level(\d+)_attn(\d+)/ff_proj/", r"encoder_down_attention_blocks/\1/\2/ff/net/0/proj/"),
            (r"^level(\d+)_attn(\d+)/ff_out/", r"encoder_down_attention_blocks/\1/\2/ff/net/2/"),
            (r"^level(\d+)_attn(\d+)/ff_norm/", r"encoder_down_attention_blocks/\1/\2/ff_norm/")]


def _sub(path, rules):
    for pat, repl in rules:
        path = re.sub(pat, repl, path)
    return path


def reference_key(jax_name: str, unet_cfg) -> str:
    """A reference state-dict key for the JAX-named parameter `jax_name`."""
    comp, rest = jax_name.split("/", 1)
    if jax_name == "clip_text/token_embedding":
        return "cond_stage_model.model.token_embedding.weight"
    rest = "/".join(p for p in rest.split("/") if p not in ("GroupNorm_0", "LayerNorm_0"))
    rest = re.sub(r"/(kernel|scale)$", "/weight", rest) if "/" in rest else re.sub(r"^(kernel|scale)$", "weight", rest)
    if comp == "unet":
        blocks = {ours: ref for ref, ours in PI._unet_block_map(unet_cfg).items()}
        head, _, tail = rest.partition("/")
        if head in blocks:
            head = blocks[head]
        rest = head + "/" + _sub(tail, UNET_INV)
    else:
        rest = _sub(rest, {"vae": VAE_INV, "clip_text": CLIP_INV, "clip_vision": CLIP_INV, "image_proj": RESAMPLER_INV,
                           "adaptor": RESAMPLER_INV, "pose_encoder": POSE_INV}.get(comp, []))
    return PREFIX[comp] + rest.replace("/", ".")


def reference_state_dict(tree: dict, unet_cfg) -> dict:
    """{reference key: value in the reference's layout} for every leaf of a
    JAX-named parameter tree."""
    from camc2v_tpu.utils.torch_import import _inverse_transform

    sd = {}
    for name, v in flat(tree).items():
        v = np.asarray(v)
        if name.endswith("/kernel"):
            rank = 3 if re.match(r"unet/init_attn/proj_(in|out)/", name) else v.ndim
            v = _inverse_transform(v, rank)
        sd[reference_key(name, unet_cfg)] = np.array(v, order="C")
    return sd


@pytest.fixture(scope="module")
def tiny():
    jm = plain_tiny("camcontext")
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    source = seeded_params_for(tm, seed=5)  # the checkpoint's values
    start = seeded_params_for(tm, seed=0)  # the model's before the import
    return jm, tm, source, start


def _params(module):
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def test_copied_map_equals_the_original():
    """The copied key map, leaf naming and layout transforms agree with
    `camc2v_tpu/utils/torch_import.py` on every key of its test table and
    every skipped key (the copy renames only its variables)."""
    import test_checkpoint as TC
    from camc2v_tpu.utils import torch_import as JI

    keys = [k for k, _ in TC.test_reference_key_mapping.pytestmark[0].args[1]]
    keys += list(TC.test_skipped_keys.pytestmark[0].args[1]) + ["module.model.diffusion_model.framestride_embed.2.bias",
                                                                 "unknown.prefix.weight"]
    for k in keys:
        assert PI.map_reference_key(k, TC.UNET_CFG) == JI.map_reference_key(k, TC.UNET_CFG), k
        mapped = JI.map_reference_key(k, TC.UNET_CFG)
        if mapped is not None:
            for rank in (1, 2, 4):
                assert PI._leaf_name(mapped, rank) == JI._leaf_name(mapped, rank), k
    rng = np.random.default_rng(0)
    for shape in [(6, 4), (6, 4, 1), (6, 4, 3, 3), (6, 4, 2, 3, 3), (5,)]:
        arr = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_array_equal(PI._transform(arr), JI._transform(arr))
    assert PI._unet_block_map(TC.UNET_CFG) == JI._unet_block_map(TC.UNET_CFG)
    for name in ("_SKIP_PATTERNS", "_SUBMODULE_RULES", "_VAE_RULES", "_CLIP_RULES", "_RESAMPLER_RULES",
                 "_POSE_ENCODER_RULES"):
        assert getattr(PI, name) == getattr(JI, name), name


def test_every_parameter_is_reachable_and_the_import_equals_jax(tiny):
    """A reference state dict covering every parameter of a TINY port
    CamContextI2V (plus keys the importer skips) goes through the port's
    import and through the JAX import + `load_jax_params`: the same tensors,
    bit for bit, equal to the checkpoint's values; the report the JAX
    report's."""
    from camc2v_tpu.utils import torch_import as JI

    jm, tm, source, start = tiny
    unet_cfg = jm.config.unet
    sd = reference_state_dict(source, unet_cfg)
    for name in flat(source):  # every parameter reachable from its key
        key = reference_key(name, unet_cfg)
        assert JI._leaf_name(PI.map_reference_key(key, unet_cfg), 2)[0] == name, (name, key)
    sd.update({"betas": np.zeros(1000), "model_ema.decay": np.zeros(()),
               "cond_stage_model.model.attn_mask": np.zeros((77, 77)), "embedder.model.visual.proj": np.zeros((4, 4))})
    load_jax_params(tm, flat(start))
    report = PI.import_state_dict(tm, {k: torch.from_numpy(v) for k, v in sd.items()}, unet_cfg, strict=True)
    got = _params(tm)
    new, jreport = JI.import_state_dict(sd, start, unet_cfg)
    load_jax_params(tm, flat(new))
    want = _params(tm)
    load_jax_params(tm, flat(source))
    src = _params(tm)
    assert set(got) == set(want) == set(src)
    for k in got:
        assert torch.equal(got[k], want[k]) and torch.equal(got[k], src[k]), k
    assert len(report["mapped"]) == len(got) == len(flat(source))
    assert sorted(report["mapped"]) == sorted(jreport["mapped"])
    assert not report["missing_params"] and not jreport["missing_params"]
    assert not report["unmatched_ckpt"] and not report["shape_mismatch"]


def test_lax_import_reports_and_strict_raises(tiny):
    """Without strict, what matches is loaded and the rest reported: a key
    that names no parameter, a shape mismatch, parameters no key filled (the
    JAX report's lists); with strict, an unmatched key or a shape mismatch
    raises and nothing is copied."""
    from camc2v_tpu.utils import torch_import as JI

    jm, tm, source, start = tiny
    unet_cfg = jm.config.unet
    sd = reference_state_dict(source, unet_cfg)
    dropped = reference_key("unet/conv_in/bias", unet_cfg)
    bad_shape = reference_key("zero_conv/bias", unet_cfg)
    sd.pop(dropped)
    sd[bad_shape] = np.zeros(7, np.float32)
    sd["model.diffusion_model.no_such_block.weight"] = np.zeros(3, np.float32)
    for strict_sd in ({k: v for k, v in sd.items() if k != bad_shape}, {k: v for k, v in sd.items()
                                                                        if not k.startswith("model.diffusion_model.no_")}):
        load_jax_params(tm, flat(start))
        before = _params(tm)
        with pytest.raises(ValueError, match="strict import failed"):
            PI.import_state_dict(tm, strict_sd, unet_cfg, strict=True)
        assert all(torch.equal(v, before[k]) for k, v in _params(tm).items())
    report = PI.import_state_dict(tm, sd, unet_cfg)
    _, jreport = JI.import_state_dict(sd, start, unet_cfg)
    assert report["unmatched_ckpt"] == jreport["unmatched_ckpt"] == ["model.diffusion_model.no_such_block.weight"]
    assert [r[:3] for r in report["shape_mismatch"]] == [r[:3] for r in jreport["shape_mismatch"]]
    assert report["missing_params"] == ["unet.conv_in.bias", "zero_conv.bias"]
    assert sorted(jreport["missing_params"]) == ["unet/conv_in/bias", "zero_conv/bias"]
    got, start_p = _params(tm), None
    load_jax_params(tm, flat(start))
    start_p = _params(tm)
    assert torch.equal(got["unet.conv_in.bias"], start_p["unet.conv_in.bias"])
    assert not torch.equal(got["unet.conv_in.weight"], start_p["unet.conv_in.weight"])


def test_train_entry_point_imports_the_pretrained_checkpoint(tmp_path, caplog):
    """`main/train.py` imports a reference `.pt` (written with `torch.save`,
    Lightning's {'state_dict': ...} form) that the yaml's
    `pretrained_checkpoint` names: every parameter loaded, and the frozen
    ones still the checkpoint's after a step."""
    from test_torch_train_data import write_tree
    from test_torch_train_run import tiny_yaml

    from camc2v_tpu_torch.config_yaml import build_model_from_config, load_yaml
    from camc2v_tpu_torch.main import train

    config = tiny_yaml(tmp_path / "tiny.yaml", write_tree(tmp_path / "re10k", ["v0", "v1"]))
    model, _ = build_model_from_config(load_yaml(config), device="cpu", seed=3)
    sd = reference_state_dict(seeded_params_for(model, seed=6), model.config.unet)
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    pt = tmp_path / "ref.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, pt)
    argv = ["--config", config, "--device", "cpu", "--logdir", str(tmp_path / "runs"), "--name", "tiny",
            "--pretrained", str(pt), "data.params.num_workers=0", "lightning.trainer.log_every_n_steps=1",
            "lightning.logger=csv", "lightning.callbacks.batch_logger.params.train_batch_frequency=100",
            "lightning.callbacks.metrics_over_trainsteps_checkpoint.params.every_n_train_steps=100",
            "lightning.trainer.val_check_interval=100", "--max_steps", "1"]
    trainer, _ = train.main(argv)
    text = caplog.text
    assert f"imported {len(ref)} tensors from {pt} (0 unmatched, 0 ours missing, 0 shape mismatches)" in text
    frozen = {n: p for n, p in trainer.model.named_parameters() if n.startswith(("unet.", "vae."))}
    assert frozen and all(torch.equal(p.detach(), ref[n].to(p.dtype)) for n, p in frozen.items())
