"""The MotionCtrl and CameraCtrl baselines of the port against the JAX package.

Both families at the oracle TINY dims (`refload.my_model`), CLIP text at 2
layers and the resampler fed by the vision tower, in f32 on the same numpy
inputs. The JAX parameter tree is the shape tree of the JAX `init_params`
(with its `example_camera_payload`, so every `cc_projection` exists) filled
from a seeded numpy generator (`test_torch_port_modules.seeded_tree`: no
leaf zero, so MotionCtrl's projection is not the identity and CameraCtrl's
adds something), and goes into the port by the strict `load_jax_params`.
Checked: the parameter names; both camera branches of
`BasicTransformerBlock` and MotionCtrl's `init_attn`, module against module;
`camera_condition` at conditioning frames 0 and 1; `apply_model` (`sample`
end to end is in test_torch_baselines_sample.py); the trainable set each yaml
selects; the reference `.pt` import of both families' keys, `cc_projection`
included, against the JAX import. At TINY every path is the plain one on
both sides. Tolerance: 1e-4 of the output's max |value| (f32, summation
order only).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import my_model  # noqa: E402
from test_torch_camera_generate import batches  # noqa: E402
from test_torch_port_modules import (  # noqa: E402,F401
    _normal,
    assert_close,
    flat,
    jax_params,
    jit_o0,
    one_torch_thread,
    port_config,
    run_both,
    seeded_tree,
)

from camc2v_tpu_torch.utils.weights import _to_torch_layout, jax_to_torch_name, load_jax_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ("motionctrl", "cameractrl")
YAML = {"motionctrl": "configs/baseline/motionctrl_256.yaml", "cameractrl": "configs/baseline/cameractrl_256.yaml"}
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def tiny_baseline(family):
    jm = my_model(family)
    c = jm.config
    cfg = dataclasses.replace(c, clip_text=dataclasses.replace(c.clip_text, layers=2),
                              resampler=dataclasses.replace(c.resampler, embedding_dim=c.clip_vision.width))
    return type(jm)(cfg, dtype=jnp.float32)


def step_inputs():
    """A UNet call's inputs beside the batch: x, c_concat, the context and
    the timesteps, drawn from a seeded numpy generator."""
    rng = np.random.default_rng(6)
    x, c_concat = (rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ctx = rng.standard_normal((2, 77 + 64, 16)).astype(np.float32)
    return x, c_concat, ctx, np.array([10, 700], np.int32)


def baseline_pair(family):
    """(JAX model, seeded JAX parameters, port model holding them)."""
    from camc2v_tpu_torch.models.camera_base import CameraCtrl, MotionCtrl

    jm = tiny_baseline(family)
    shapes = jax.eval_shape(lambda k: jm.init_params(k, (32, 32)), jax.random.key(0))
    params = seeded_tree(shapes, seed=1)
    tm = {"motionctrl": MotionCtrl, "cameractrl": CameraCtrl}[family](port_config(jm.config), dtype=torch.float32)
    load_jax_params(tm, flat(params))
    return jm, params, tm


@pytest.fixture(scope="module")
def built():
    """family -> (JAX model, seeded JAX parameters, port model holding them,
    the JAX reference outputs), built once per family. The references come
    from one compiled JAX program: `camera_condition` at conditioning frames
    0 and 1 and one `apply_model` on the payload of frames (0, 1). (`sample`
    has its own program, in test_torch_baselines_sample.py.)"""
    cache = {}

    def get(family):
        if family not in cache:
            jm, params, tm = baseline_pair(family)

            def reference(p, batch, x, c_concat, ctx, t):
                camera = [jm.camera_condition(p, batch, jnp.full((2,), i, jnp.int32), 1.0) for i in (0, 1)]
                cond = {"c_concat": c_concat, "c_crossattn": ctx,
                        "camera": jm.camera_condition(p, batch, jnp.array([0, 1], jnp.int32), 1.0)}
                return dict(camera=camera, eps=jm.apply_model(p, x, t, cond, jm.get_fs(batch)))

            jb, _ = batches(n_ctx=0)
            ref = jit_o0(reference)(params, jb, *(jnp.asarray(a) for a in step_inputs()))
            cache[family] = jm, params, tm, jax.tree_util.tree_map(np.asarray, ref)
        return cache[family]

    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_parameter_names_equal_the_jax_init(built, family):
    """The JAX init's parameter names are the port's, one to one: a
    `cc_projection` in every temporal block and, for MotionCtrl alone, in
    init_attn, of (dim + 12, dim) for MotionCtrl and (dim, dim) for
    CameraCtrl (JAX kernel layout)."""
    from camc2v_tpu_torch.nn.attention import TemporalTransformer

    jm, params, tm, _ = built(family)
    names = flat(params)
    assert {jax_to_torch_name(k) for k in names} == set(tm.state_dict()) == {n for n, _ in tm.named_parameters()}
    temporal = [n for n, m in tm.unet.named_children() if isinstance(m, TemporalTransformer)]
    want = sorted(f"unet/{n}/block_0/cc_projection/kernel" for n in temporal
                  if n != "init_attn" or family == "motionctrl")
    assert "init_attn" in temporal and len(want) == len(temporal) - (family == "cameractrl")
    assert sorted(k for k in names if k.endswith("cc_projection/kernel")) == want
    for key in want:
        dim = tm.unet.get_submodule(key.split("/")[1]).proj_in.weight.shape[0]
        assert names[key].shape == ((dim + 12, dim) if family == "motionctrl" else (dim, dim)), key
    if family == "cameractrl":
        # without a pose encoder JAX's init hands the UNet no payload, so no block has a cc_projection
        no_pe = dataclasses.replace(jm.config, pose_encoder=None)
        assert type(jm)(no_pe).example_camera_payload((32, 32)) is None
        assert not any("cc_projection" in n for n in type(tm)(port_config(no_pe), dtype=torch.float32).state_dict())


@pytest.mark.parametrize("case", ["motionctrl", "cameractrl", "motionctrl_init_attn"])
def test_camera_branches_match_jax(case):
    """Each camera branch of a temporal BasicTransformerBlock (B 2, T 4,
    2x2 tokens, dim 32) and MotionCtrl's init_attn (8 heads x 8 over the
    32-channel stream), with non-zero `cc_projection`s; the payload moves
    the output."""
    from camc2v_tpu.nn import attention as ja
    from camc2v_tpu_torch.nn import attention as ta

    b, t, hh, ww = 2, 4, 2, 2
    if case == "motionctrl_init_attn":
        jm = ja.TemporalTransformer(in_channels=32, n_heads=8, d_head=8, camera_mode="motionctrl")
        tm = ta.TemporalTransformer(32, 8, 8, camera_mode="motionctrl")
        x, cam, hw_kw = _normal(b, t, hh, ww, 32), {"RT": _normal(b, t, 12, seed=2)}, {}
    else:
        jm = ja.BasicTransformerBlock(dim=32, n_heads=4, d_head=8, is_temporal=True, camera_mode=case)
        tm = ta.BasicTransformerBlock(32, 4, 8, camera_mode=case)
        x, hw_kw = _normal(b * hh * ww, t, 32), dict(spatial_hw=(hh, ww))
        cam = {"RT": _normal(b, t, 12, seed=2)} if case == "motionctrl" else {"plucker": _normal(b, t, hh, ww, 32,
                                                                                                  seed=2)}
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    params = jax_params(jm, jnp.asarray(x), camera=jcam, **hw_kw)
    assert set(params["block_0"] if "block_0" in params else params) >= {"cc_projection"}
    got, ref = run_both(jm, params, tm, [x], jkw=dict(camera=jcam, **hw_kw),
                        tkw=dict(camera={k: T_(v) for k, v in cam.items()}, **hw_kw))
    assert_close(got, ref)
    with torch.no_grad():
        plain = tm(T_(x), **hw_kw).numpy()
    assert np.abs(got - plain).max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("cond_frame", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_camera_condition_matches_jax(built, family, cond_frame):
    """MotionCtrl's RT tokens (B, T, 12) and CameraCtrl's pose-encoder
    pyramid of the ray embedding, relative to conditioning frame 0 or 1."""
    _, _, tm, refs = built(family)
    _, tb = batches(n_ctx=0)
    ref = refs["camera"][cond_frame]
    with torch.no_grad():
        got = tm.camera_condition(tb, torch.full((2,), cond_frame, dtype=torch.long))
    assert set(got) == set(ref) == ({"RT"} if family == "motionctrl" else {"plucker"})
    if family == "motionctrl":
        assert got["RT"].shape == (2, 4, 12)
        assert_close(got["RT"].numpy(), np.asarray(ref["RT"]))
        assert np.abs(got["RT"].numpy()[:, cond_frame] - np.eye(4)[:3].reshape(12)).max() < 1e-5
    else:
        assert [tuple(g.shape) for g in got["plucker"]] == [(2, 4, 4, 4, 32), (2, 4, 2, 2, 96)]
        for g, r in zip(got["plucker"], ref["plucker"]):
            assert_close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("family", FAMILIES)
def test_apply_model_matches_jax(built, family):
    """One UNet call on a camera payload of conditioning frames 0 and 1;
    without the payload the output moves."""
    _, _, tm, refs = built(family)
    _, tb = batches(n_ctx=0)
    x, c_concat, ctx, t = step_inputs()
    ref = refs["eps"]
    with torch.no_grad():
        cond = {"c_concat": T_(c_concat), "c_crossattn": T_(ctx)}
        camera = tm.camera_condition(tb, torch.tensor([0, 1]))
        got = tm.apply_model(T_(x), T_(t), dict(cond, camera=camera), tm.get_fs(tb)).numpy()
        plain = tm.apply_model(T_(x), T_(t), cond, tm.get_fs(tb)).numpy()
    assert got.shape == (2, 4, 4, 4, 4)
    assert_close(got, ref)
    assert np.abs(got - plain).max() > 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("family", FAMILIES)
def test_trainable_set_from_yaml_matches_jax(built, family):
    """The parameters each yaml trains (MotionCtrl: the temporal blocks'
    attn2 and every cc_projection; CameraCtrl: the pose encoder and every
    cc_projection), the port's rule on the port's names against the JAX
    rule on the JAX tree."""
    from camc2v_tpu import config_yaml as jcy
    from camc2v_tpu.parallel.trainer import param_labels as jax_labels

    from camc2v_tpu_torch import config_yaml as tcy
    from camc2v_tpu_torch.parallel.trainer import param_labels

    _, params, tm, _ = built(family)
    jcfg = jcy.build_train_config(jcy.load_yaml(str(REPO / YAML[family])))
    tcfg = tcy.build_train_config(tcy.load_yaml(str(REPO / YAML[family])))
    jlab = flat(jax_labels(params, jcfg.trainable_patterns))
    want = sorted(jax_to_torch_name(k) for k, lab in jlab.items() if lab == "train")
    got = sorted(n for n, lab in param_labels(tm, tcfg.trainable_patterns).items() if lab == "train")
    assert got == want
    assert any("cc_projection" in n for n in got) and not any(n.startswith(("vae.", "clip_")) for n in got)
    part = "attn2." if family == "motionctrl" else "pose_encoder."
    assert any(part in n for n in got) and all("cc_projection" in n or part in n for n in got)


@pytest.mark.parametrize("family", FAMILIES)
def test_reference_import_matches_jax(built, family):
    """A fabricated reference state dict of every parameter (the
    `cc_projection` keys of each temporal block, and init_attn's for
    MotionCtrl, included) through the port's import and through the JAX
    import + `load_jax_params`: the same tensors, bit for bit, equal to the
    checkpoint's values."""
    from test_torch_import import reference_state_dict

    from camc2v_tpu.utils import torch_import as JI

    from camc2v_tpu_torch.utils import torch_import as PI

    jm, params, tm, _ = built(family)
    unet_cfg = jm.config.unet
    source = flat(seeded_tree(params, seed=7))
    sd = reference_state_dict(source, unet_cfg)
    cc_keys = [k for k in sd if "cc_projection" in k]
    assert len(cc_keys) == sum("cc_projection" in k for k in source) > 0
    assert any(".init_attn." in k for k in cc_keys) == (family == "motionctrl")
    report = PI.import_state_dict(tm, {k: torch.from_numpy(v) for k, v in sd.items()}, unet_cfg, strict=True)
    got = {k: v.detach().clone() for k, v in tm.named_parameters()}
    new, jreport = JI.import_state_dict(sd, params, unet_cfg)
    load_jax_params(tm, flat(new))
    want = {k: v.detach().clone() for k, v in tm.named_parameters()}
    load_jax_params(tm, flat(params))  # the fixture's weights back for the other tests
    assert sorted(report["mapped"]) == sorted(jreport["mapped"]) and len(report["mapped"]) == len(got)
    assert not report["missing_params"] and not jreport["missing_params"] and not report["unmatched_ckpt"]
    for key, value in source.items():
        name = jax_to_torch_name(key)
        assert torch.equal(got[name], want[name]), name
        assert np.array_equal(got[name].numpy(), _to_torch_layout(key, value)), name
