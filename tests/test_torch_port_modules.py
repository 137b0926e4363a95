"""The PyTorch port's modules against the JAX package, plus the port's rules.

Modules are built at the oracle TINY dims of `refload.my_model("dynamicrafter")`
(the UNet at MID, which has the flagship's four-level ds routing, is in
test_torch_port_generate.py), run in
f32 on the same numpy inputs, with the same weights: the JAX parameter tree
comes from `jax.eval_shape` of the module's init and every leaf is drawn from
a seeded numpy generator, then `load_jax_params` moves it into the port. No
leaf is zero, so the zero-init branches (proj_out, out_conv, the fs
embedding, the temporal conv) are live, which is what
`tests/util.py::perturb_zero_kernels` is for. Drawing the tree instead of
running `init_params` + `perturb_zero_kernels` keeps the files cheap: at
TINY those two take 61 s (jitted init) + 15 s on the CPU, more than this
file's whole run.

Tolerance: 1e-4 of the output's max |value| for every f32 module (the same
f32 arithmetic in another summation order; observed errors are ~1e-6).
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import TINY, my_model  # noqa: E402

from camc2v_tpu_torch import config as pc
from camc2v_tpu_torch.utils.weights import load_jax_params

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4


def jax_params(module, *args, seed=0, **kwargs):
    """A seeded, fully non-zero flax parameter tree for `module.init(*args)`."""
    return seeded_tree(jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.key(0))["params"], seed)


def seeded_tree(shapes, seed=0):
    """Fill a tree of `ShapeDtypeStruct`s from a seeded numpy generator:
    norm scales ~1, biases and gates small, kernels N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(getattr(path[-1], "key", ""))
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif name in ("bias", "alpha"):
            v = 0.1 * rng.standard_normal(s.shape)
        else:
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 1
            v = rng.standard_normal(s.shape) / np.sqrt(fan_in)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def port_config(jcfg, cls=None):
    """The port's dataclass with the JAX dataclass's values (shared fields)."""
    cls = cls or getattr(pc, type(jcfg).__name__)
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def run_both(jmod, params, tmod, jargs, targs=None, jkw=None, tkw=None, method=None):
    """Apply the flax module (jitted) and the port module to the same inputs."""
    load_jax_params(tmod, flat(params))
    fn = jax.jit(lambda p, *a: jmod.apply({"params": p}, *a, method=method, **(jkw or {})))
    ref = np.asarray(fn(params, *(jnp.asarray(a) for a in jargs)))
    targs = targs if targs is not None else [torch.from_numpy(np.asarray(a)) for a in jargs]
    with torch.no_grad():
        got = (getattr(tmod, method.__name__) if method is not None else tmod)(*targs, **(tkw or {}))
    return got.float().numpy(), ref


def assert_close(got, ref, tol=TOL):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1.0, float(np.abs(ref).max())))


def _normal(*shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ rules


def compare_preset(name):
    """The port's preset `name` against the JAX one, field by field."""
    from camc2v_tpu import presets as jp
    from camc2v_tpu_torch import presets as tp

    jcfg, tcfg = getattr(jp, name)(), getattr(tp, name)()

    def compare(j, t, where):
        assert type(t).__name__ == type(j).__name__, where
        jf = {f.name for f in dataclasses.fields(j)}
        tf = {f.name for f in dataclasses.fields(t)}
        assert tf <= jf, f"{where}: port fields not in JAX: {tf - jf}"
        assert jf == tf, f"{where}: JAX fields missing in the port: {jf - tf}"
        for field in tf:
            jv, tv = getattr(j, field), getattr(t, field)
            if dataclasses.is_dataclass(jv):
                compare(jv, tv, f"{where}.{field}")
            else:
                assert jv == tv and type(jv) is type(tv), f"{where}.{field}: {jv!r} vs {tv!r}"

    compare(jcfg, tcfg, name)
    assert tcfg.video_length == jcfg.video_length and tcfg.latent_channels == jcfg.latent_channels


def test_preset_matches_jax_field_by_field():
    compare_preset("dynamicrafter_256")


@pytest.mark.parametrize("name", ["cami2v_256", "camcontexti2v_256"])
def test_camera_presets_match_jax_field_by_field(name):
    compare_preset(name)


def test_port_imports_no_jax():
    """Every port module and chip_smoke.py import without jax or flax."""
    code = (
        "import importlib, pkgutil, sys, camc2v_tpu_torch\n"
        "for m in pkgutil.walk_packages(camc2v_tpu_torch.__path__, 'camc2v_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'camc2v_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300)
    # chip_smoke.py may time scaled dot-product attention as a yardstick; the
    # port never calls it
    jax_like = r"import jax|from jax|flax|torch\.compile"
    checks = [(REPO / "chip_smoke.py", re.compile(jax_like))] + [
        (p, re.compile(jax_like + r"|scaled_dot_product_attention"))
        for p in sorted((REPO / "camc2v_tpu_torch").rglob("*.py"))]
    hits = [f"{p}:{i}" for p, pattern in checks for i, line in enumerate(p.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


def test_cuda_request_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter
    from camc2v_tpu_torch.presets import dynamicrafter_256

    with pytest.raises((RuntimeError, AssertionError)):
        with torch.device("cuda"):
            DynamiCrafter(dynamicrafter_256())
    # the smoke run fails without a card (here: alone, without the repo beside it)
    (tmp_path / "chip_smoke.py").write_bytes((REPO / "chip_smoke.py").read_bytes())
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout, (r.returncode, r.stdout[-500:])


def test_weight_bridge_is_strict():
    from camc2v_tpu.nn.layers import ResBlock as JResBlock
    from camc2v_tpu_torch.nn.layers import ResBlock

    jm = JResBlock(out_channels=48, use_temporal_conv=True)
    params = flat(jax_params(jm, jnp.zeros((4, 2, 2, 32)), jnp.zeros((4, 64)), batch_size=2))
    make = lambda: ResBlock(32, 48, 64, use_temporal_conv=True)
    load_jax_params(make(), params)
    with pytest.raises(ValueError, match="unused"):
        load_jax_params(make(), {**params, "extra/kernel": np.zeros((2, 2), np.float32)})
    load_jax_params(make(), {**params, "extra/kernel": np.zeros((2, 2), np.float32)}, skip=[r"extra/.*"])
    with pytest.raises(ValueError, match="not filled"):
        load_jax_params(make(), {k: v for k, v in params.items() if not k.startswith("skip/")})
    bad = dict(params)
    bad["in_conv/kernel"] = np.zeros((3, 3, 32, 47), np.float32)
    with pytest.raises(ValueError, match="in_conv"):
        load_jax_params(make(), bad)
    # a Dense kernel arrives transposed, a conv kernel as OIHW
    m = make()
    load_jax_params(m, params)
    np.testing.assert_array_equal(m.emb_proj.weight.detach().numpy(), params["emb_proj/kernel"].T)
    np.testing.assert_array_equal(m.in_conv.weight.detach().numpy(), params["in_conv/kernel"].transpose(3, 2, 0, 1))


# --------------------------------------------------------------- modules


def test_resblock_matches_jax():
    from camc2v_tpu.nn.layers import ResBlock as JResBlock
    from camc2v_tpu_torch.nn.layers import ResBlock

    x, emb = _normal(8, 4, 4, 32), _normal(8, 128, seed=2)  # TINY: B=2 x T=4 frames at ds1
    jm = JResBlock(out_channels=96, use_temporal_conv=True)
    params = jax_params(jm, jnp.asarray(x), jnp.asarray(emb), batch_size=2)
    got, ref = run_both(jm, params, ResBlock(32, 96, 128, use_temporal_conv=True), [x, emb],
                        jkw=dict(batch_size=2), tkw=dict(batch_size=2))
    assert_close(got, ref)


def test_cross_attention_dual_context_matches_jax():
    from camc2v_tpu.nn.attention import CrossAttention as JCross
    from camc2v_tpu_torch.nn.attention import CrossAttention

    x, ctx = _normal(8, 16, 32), _normal(8, 77 + 16, 16, seed=2)
    kw = dict(heads=4, dim_head=8, image_cross_attention=True, image_cross_attention_scale_learnable=True)
    jm = JCross(query_dim=32, context_dim=16, **kw)
    params = jax_params(jm, jnp.asarray(x), jnp.asarray(ctx))
    assert params["alpha"] != 0
    got, ref = run_both(jm, params, CrossAttention(32, 16, **kw), [x, ctx])
    assert_close(got, ref)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_transformers_match_jax(kind):
    from camc2v_tpu.nn import attention as ja
    from camc2v_tpu_torch.nn import attention as ta

    if kind == "spatial":
        kw = dict(image_cross_attention=True, image_cross_attention_scale_learnable=True)
        jm = ja.SpatialTransformer(in_channels=96, n_heads=12, d_head=8, context_dim=16, **kw)
        tm = ta.SpatialTransformer(96, 12, 8, context_dim=16, **kw)
        args = [_normal(8, 2, 2, 96), _normal(8, 77 + 16, 16, seed=2)]
    else:
        jm = ja.TemporalTransformer(in_channels=96, n_heads=12, d_head=8)
        tm = ta.TemporalTransformer(96, 12, 8)
        args = [_normal(2, 4, 2, 2, 96)]
    params = jax_params(jm, *(jnp.asarray(a) for a in args))
    got, ref = run_both(jm, params, tm, args)
    assert_close(got, ref)


@pytest.fixture(scope="module")
def tiny_dc():
    """The JAX TINY DynamiCrafter; CLIP text gets 2 layers so the
    penultimate output runs one resblock."""
    m = my_model("dynamicrafter")
    cfg = dataclasses.replace(m.config, clip_text=dataclasses.replace(m.config.clip_text, layers=2))
    return type(m)(cfg, dtype=jnp.float32)


@pytest.mark.parametrize("method", ["encode", "decode"])
def test_vae_matches_jax(tiny_dc, method):
    from camc2v_tpu_torch.nn.vae import AutoencoderKL

    jm = tiny_dc.vae
    params = jax_params(jm, jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    if method == "decode":
        x = _normal(2, 4, 4, 4)
    tm = AutoencoderKL(port_config(jm.config))
    got, ref = run_both(jm, params, tm, [x], method=getattr(type(jm), method))
    assert_close(got, ref)


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_clip_towers_match_jax(tiny_dc, tower):
    from camc2v_tpu_torch.nn import clip as tc

    if tower == "text":
        jm = tiny_dc.clip_text
        x = np.random.default_rng(1).integers(0, 64, (2, 77)).astype(np.int32)
        tm = tc.CLIPTextTower(port_config(jm.config))
        targs = [torch.from_numpy(x).long()]
    else:
        jm = tiny_dc.clip_vision
        x = _normal(2, 224, 224, 3)
        tm = tc.CLIPVisionTower(port_config(jm.config))
        targs = None
    params = jax_params(jm, jnp.asarray(x))
    got, ref = run_both(jm, params, tm, [x], targs=targs)
    assert_close(got, ref)


@pytest.mark.parametrize("size", [32, 256])
def test_clip_preprocess_matches_jax(size):
    """Bicubic to 224: upsampling at TINY (32), antialiased downsampling at
    the flagship's 256."""
    from camc2v_tpu.nn.clip import clip_preprocess as jpre
    from camc2v_tpu_torch.nn.clip import clip_preprocess

    x = np.random.default_rng(1).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)
    assert_close(clip_preprocess(torch.from_numpy(x)).numpy(), np.asarray(jpre(jnp.asarray(x))))


def test_resampler_matches_jax(tiny_dc):
    from camc2v_tpu_torch.nn.resampler import Resampler

    jm = tiny_dc.image_proj
    x = _normal(2, 5, 12)
    params = jax_params(jm, jnp.asarray(x))
    rs = tiny_dc.config.resampler
    tm = Resampler(**{f.name: getattr(rs, f.name) for f in dataclasses.fields(rs)})
    got, ref = run_both(jm, params, tm, [x])
    assert_close(got, ref)


@pytest.mark.parametrize("dims", [TINY], ids=["tiny"])
def test_unet_matches_jax(dims):
    """The UNet at TINY; MID is checked in test_torch_port_generate.py."""
    from camc2v_tpu_torch.nn.unet3d import UNetModel

    jm = my_model("dynamicrafter", dims=dims).unet
    t, lat, lctx = dims.T, dims.LAT, 77 + dims.T * 16
    params = jax_params(jm, jnp.zeros((1, t, lat, lat, 8)), jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, lctx, 16)), jnp.ones((1,), jnp.int32))
    x, ctx = _normal(2, t, lat, lat, 8), _normal(2, lctx, 16, seed=2)
    ts, fs = np.array([10, 700], np.int32), np.array([3, 5], np.int32)
    tm = UNetModel(port_config(jm.config, pc.UNetConfig), dtype=torch.float32)
    got, ref = run_both(jm, params, tm, [x, ts, ctx, fs])
    assert got.shape == (2, t, lat, lat, 4)
    assert_close(got, ref)


# ------------------------------------------------------ schedules, sampler


def tiny_generation_config():
    """The oracle TINY DynamiCrafter config, made whole for `sample`: CLIP
    text gets 2 layers so the penultimate output runs one resblock, and the
    resampler's input width follows the vision tower's (16)."""
    jcfg = my_model("dynamicrafter").config
    return dataclasses.replace(
        jcfg,
        clip_text=dataclasses.replace(jcfg.clip_text, layers=2),
        resampler=dataclasses.replace(jcfg.resampler, embedding_dim=jcfg.clip_vision.width),
    )


def test_sample_loop_never_syncs_with_the_host(monkeypatch):
    """The DDIM loop and the guided UNet calls read nothing back to the host
    (no `.item()`, `.cpu()`, `.numpy()`, `.tolist()` or tensor truth test),
    so on the card the loop only enqueues work."""
    from camc2v_tpu_torch.models import dynamicrafter as dc
    from camc2v_tpu_torch.utils.weights import init_weights

    tm = dc.DynamiCrafter(port_config(tiny_generation_config()), dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    batch = dict(video=torch.from_numpy(rng.uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32)),
                 caption_tokens=torch.from_numpy(rng.integers(0, 62, (1, 77))),
                 frame_stride=torch.tensor([3], dtype=torch.int32))
    with torch.no_grad():
        z, cond = tm.prepare_batch(batch, prefetch_uncond=True)
        shape = z.shape
        uc = tm.build_uncond(cond, 1, (32, 32))
    cond.pop("_uncond")
    fn = tm.build_guided_fn(cond, uc, tm.get_fs(batch), guidance_scale=7.5, guidance_rescale=0.7)
    ddim = dc.DDIMSchedule.create(tm.schedule, 3, "uniform_trailing", 1.0)
    x_t = torch.randn(shape, generator=torch.Generator().manual_seed(0))

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the sampling loop")

    for name in ("item", "cpu", "numpy", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.no_grad():
        out = dc.ddim_sample(ddim, x_t, fn, generator=torch.Generator().manual_seed(1))
    monkeypatch.undo()
    assert out.shape == shape and torch.isfinite(out).all()


def test_step_noise_must_cover_every_step():
    from camc2v_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
    from camc2v_tpu_torch.models.sampler import ddim_sample

    ddim = DDIMSchedule.create(DiffusionSchedule.create(), 3, "uniform_trailing", 1.0)
    x = torch.zeros(1, 4, 4, 4, 4)
    with pytest.raises(ValueError, match="step_noise"):
        ddim_sample(ddim, x, lambda x_, t_: x_, step_noise=[x] * 2)


@pytest.mark.parametrize("spacing,eta", [("uniform_trailing", 1.0), ("uniform", 0.0), ("quad", 0.5)])
def test_ddim_schedule_matches_jax(spacing, eta):
    from camc2v_tpu.core import schedules as js

    from camc2v_tpu_torch.core import schedules as ts

    kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.012)
    jd = js.DDIMSchedule.create(js.DiffusionSchedule.create(**kw), 25, spacing, eta)
    td = ts.DDIMSchedule.create(ts.DiffusionSchedule.create(**kw), 25, spacing, eta)
    np.testing.assert_array_equal(td.timesteps, np.asarray(jd.timesteps))
    for name in ("alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(td, name), np.asarray(getattr(jd, name)), err_msg=name)


def test_embedding_and_guidance_helpers_match_jax():
    from camc2v_tpu.core import schedules as js
    from camc2v_tpu.models.dynamicrafter import empty_prompt_tokens as j_empty

    from camc2v_tpu_torch.core import schedules as ts
    from camc2v_tpu_torch.models.dynamicrafter import empty_prompt_tokens

    steps = np.array([0, 1, 250, 999], np.int32)
    for dim in (320, 33):
        got = ts.timestep_embedding(torch.from_numpy(steps), dim).numpy()
        # the f32 phase t * freq reaches ~1e3, whose ulp is 6.1e-5: two ulps
        # of phase error in either library's cos/sin
        np.testing.assert_allclose(got, np.asarray(js.timestep_embedding(jnp.asarray(steps), dim)), atol=1.3e-4)
    rng = np.random.default_rng(0)
    cfg_, text = rng.normal(0, 2, (2, 4, 3, 3, 4)), rng.normal(size=(2, 4, 3, 3, 4))
    cfg_, text = cfg_.astype(np.float32), text.astype(np.float32)
    got = ts.rescale_noise_cfg(torch.from_numpy(cfg_), torch.from_numpy(text), 0.7).numpy()
    np.testing.assert_allclose(got, np.asarray(js.rescale_noise_cfg(jnp.asarray(cfg_), jnp.asarray(text), 0.7)),
                               rtol=1e-5, atol=1e-6)
    assert empty_prompt_tokens(49408, 77) == j_empty(49408, 77)
