"""Every option of generation in the port against the JAX package.

The sampling loops (`models/sampler.py`) against `camc2v_tpu/models/
sampler.py` with one closed-form denoiser written in both frameworks,
0.1 x + 0.05 mean_frames(x) + sin(t / 1000) (no UNet; the frame mean lets
the pasted and re-noised frames reach the others): the same numpy inputs,
and the JAX key chain's draws handed to the port through `step_noise`, one
record per step (`jax_draws`). Tolerance: 1e-5 of the output's max |value| (float32 on both
sides; the per-step coefficients are the same float32 table entries).

The model (`models/dynamicrafter.py`, `camcontexti2v.py`) at the oracle TINY
dims with seeded, fully non-zero weights (`seeded_params_for`, so the camera
and CFG branches are live): one guided evaluation under camera CFG, both
schedulers, `cfg_interval` inside and outside, fused CFG off and on;
`build_uncond` by `uncond_type`; `prepare_batch` at another conditioning
frame with the translations scaled and without the camera payload;
`p_losses` for the `v` and `x0` targets with dynamic rescale,
`perframe_ae` and `interp_mode` (a 3-step CamContextI2V `sample` with
camera CFG, the paste and a conditioning frame other than 0 is in
`test_torch_camera_sampling.py`). The guided
closure and the losses run with `apply_model` replaced by one closed form
on both sides, so they need no UNet compile. Each JAX program compiles once
(`jit_o0`) and takes what the cases change as inputs. Tolerance: 1e-4 of
the output's max |value|.
"""

import contextlib
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, camcontext, perturb_draws, seeded_params_for  # noqa: E402,F401
from test_torch_port_modules import jit_o0, one_torch_thread, port_config  # noqa: E402,F401

from camc2v_tpu_torch.core import schedules as ts  # noqa: E402
from camc2v_tpu_torch.models import sampler as tsm  # noqa: E402

SHAPE = (2, 4, 3, 3, 4)
TOL = 1e-5
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def assert_rel(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    assert scale > 0 and np.isfinite(got).all()
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"max |err| {err:.3e} > {tol} x {scale:.3e}"


def jax_out(x, t):
    return 0.1 * x + 0.05 * x.mean(axis=1, keepdims=True) + jnp.sin(t.astype(jnp.float32) / 1000.0)[
        :, None, None, None, None]


def torch_out(x, t, step):
    return 0.1 * x + 0.05 * x.mean(dim=1, keepdim=True) + torch.sin(t.float() / 1000.0)[:, None, None, None, None]


def jax_draws(key, steps, names, shapes, p_keep=None):
    """The per-step draws of a JAX loop's key chain: each step splits its key
    into (carry, *names); a name of None is a key the options leave unused;
    with p_keep the dropout key is split from the carry after, as there."""
    recs = []
    for _ in range(steps):
        ks = jax.random.split(key, 1 + len(names))
        key, rec = ks[0], {}
        for k, name in zip(ks[1:], names):
            if name is not None:
                rec[name] = T_(jax.random.normal(k, shapes[name], jnp.float32))
        if p_keep is not None:
            key, dkey = jax.random.split(key)
            rec["keep"] = T_(jax.random.bernoulli(dkey, p_keep, shapes["noise"]))
        recs.append(rec)
    return recs


def _case_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x_T=f(*SHAPE), z0=f(*SHAPE), blend_x0=f(*SHAPE),
                blend_mask=(rng.uniform(size=(2, 4, 3, 3, 1)) < 0.5).astype(np.float32),
                scene_mask=(rng.uniform(size=(2, 4, 1, 1, 1)) < 0.5).astype(np.float32),
                cfi=np.array([1, 2], np.int32))


def _scale_arr():
    """A dynamic-rescale table as the model builds it (base 0.7, turning 400)."""
    return np.concatenate([np.linspace(1.0, 0.7, 400), np.full(1000, 0.7)])[:1000].astype(np.float32)


# (loop, SamplerOptions kwargs, extra flags)
CASES = {
    "ddim_paste_overlap": ("ddim", dict(paste_cond_frame=True, num_overlap=2), {}),
    "ddim_blend_noised": ("ddim", {}, dict(blend=True)),
    "ddim_blend_clean_cond": ("ddim", dict(clean_cond=True), dict(blend=True)),
    "ddim_v_scale_arr_temperature": ("ddim", dict(parameterization="v", temperature=0.8), dict(scale=True)),
    "ddim_noise_shaping_dropout": ("ddim", dict(noise_shaping=True, noise_shaping_min_t=500, noise_dropout=0.1),
                                   dict(shaping=True)),
    "ddpm_eps_clip_blend_tstart": ("ddpm", {}, dict(blend=True, clip=True, t_start=6)),
    "ddpm_x0_temperature": ("ddpm", dict(parameterization="x0", temperature=0.9), dict(t_start=5)),
    "dpmpp_paste_overlap_v": ("dpmpp", dict(paste_cond_frame=True, num_overlap=1, parameterization="v"), {}),
    "ddim_decode": ("decode", {}, {}),
    "ddim_stochastic_encode": ("encode", {}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sampling_loop_matches_jax(case):
    from camc2v_tpu.core import schedules as js
    from camc2v_tpu.models import sampler as jsm

    loop, okw, flags = CASES[case]
    param = okw.get("parameterization", "eps")
    kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.012, parameterization=param)
    jsched, tsched = js.DiffusionSchedule.create(**kw), ts.DiffusionSchedule.create(**kw)
    scale = _scale_arr() if flags.get("scale") else None
    steps = 5
    jd = js.DDIMSchedule.create(jsched, steps, "uniform_trailing", 1.0,
                                scale_arr=None if scale is None else jnp.asarray(scale))
    td = ts.DDIMSchedule.create(tsched, steps, "uniform_trailing", 1.0, scale_arr=scale)
    a = _case_inputs()
    key = jax.random.key(3)
    jopt, topt = jsm.SamplerOptions(**okw), tsm.SamplerOptions(**okw)
    shapes = dict(noise=SHAPE, overlap=SHAPE, blend=SHAPE)
    p_keep = 1.0 - okw["noise_dropout"] if okw.get("noise_dropout") else None
    J = {k: jnp.asarray(v) for k, v in a.items()}
    blend_j = dict(blend_mask=J["blend_mask"], blend_x0=J["blend_x0"]) if flags.get("blend") else {}
    blend_t = dict(blend_mask=T_(a["blend_mask"]), blend_x0=T_(a["blend_x0"])) if flags.get("blend") else {}

    if loop == "ddim":
        shaping_j = dict(scene_mask=J["scene_mask"]) if flags.get("shaping") else {}
        shaping_t = dict(scene_mask=T_(a["scene_mask"])) if flags.get("shaping") else {}
        ref = jit_o0(lambda x, z0, cfi, k: jsm.ddim_sample(
            k, jd, x, jax_out, options=jopt, schedule=jsched, origin_z0=z0, cond_frame_index=cfi,
            **blend_j, **shaping_j))(J["x_T"], J["z0"], J["cfi"], key)
        draws = jax_draws(key, steps, ("noise", "overlap", "blend"), shapes, p_keep)
        got = tsm.ddim_sample(td, T_(a["x_T"]), torch_out, options=topt, schedule=tsched, origin_z0=T_(a["z0"]),
                              cond_frame_index=T_(a["cfi"]), step_noise=draws, **blend_t, **shaping_t)
    elif loop == "ddpm":
        n = flags["t_start"]
        ref = jit_o0(lambda x, k: jsm.p_sample_loop(k, jsched, x, jax_out, options=jopt,
                                                      clip_denoised=flags.get("clip", False), t_start=n,
                                                      **blend_j))(J["x_T"], key)
        draws = jax_draws(key, n, ("noise", "blend"), shapes)
        got = tsm.p_sample_loop(tsched, T_(a["x_T"]), torch_out, options=topt, clip_denoised=flags.get("clip", False),
                                t_start=n, step_noise=draws, **blend_t)
    elif loop == "dpmpp":
        ref = jit_o0(lambda x, z0, cfi, k: jsm.dpmpp_2m_sample(k, jd, x, jax_out, options=jopt, schedule=jsched,
                                                                origin_z0=z0, cond_frame_index=cfi))(
            J["x_T"], J["z0"], J["cfi"], key)
        draws = jax_draws(key, steps, ("overlap",), shapes)
        got = tsm.dpmpp_2m_sample(td, T_(a["x_T"]), torch_out, options=topt, schedule=tsched, origin_z0=T_(a["z0"]),
                                  cond_frame_index=T_(a["cfi"]), step_noise=draws)
    elif loop == "decode":
        ref = jit_o0(lambda x, k: jsm.ddim_decode(k, jd, x, jax_out, 3, options=jopt, schedule=jsched))(J["x_T"], key)
        draws = jax_draws(key, 3, ("noise",), shapes)
        got = tsm.ddim_decode(td, T_(a["x_T"]), torch_out, 3, options=topt, schedule=tsched, step_noise=draws)
    else:
        idx = np.array([3, 1], np.int32)
        ref = jsm.ddim_stochastic_encode(jd, J["z0"], jnp.asarray(idx), J["x_T"])
        got = tsm.ddim_stochastic_encode(td, T_(a["z0"]), T_(idx), T_(a["x_T"]))
        assert_rel(got.numpy(), np.asarray(ref), TOL)
        ref = jsm.ddim_stochastic_encode(jd, J["z0"], 2, J["x_T"])
        got = tsm.ddim_stochastic_encode(td, T_(a["z0"]), 2, T_(a["x_T"]))
    assert_rel(got.numpy(), np.asarray(ref), TOL)
    if okw.get("paste_cond_frame"):
        for bi, f in enumerate(a["cfi"]):
            assert torch.equal(got[bi, f], T_(a["z0"])[bi, f])
    if okw.get("num_overlap"):
        assert torch.equal(got[:, :okw["num_overlap"]], T_(a["z0"])[:, :okw["num_overlap"]])


def test_schedule_tables_match_jax():
    """Every DDPM buffer for the three parameterizations, and the DDIM
    dynamic-rescale tables, equal the JAX package's."""
    from camc2v_tpu.core import schedules as js

    for param in ("eps", "x0", "v"):
        kw = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085, linear_end=0.012,
                  parameterization=param)
        jsched, tsched = js.DiffusionSchedule.create(**kw), ts.DiffusionSchedule.create(**kw)
        for f in dataclasses.fields(ts.DiffusionSchedule):
            np.testing.assert_array_equal(getattr(tsched, f.name), np.asarray(getattr(jsched, f.name)),
                                          err_msg=f"{param} {f.name}")
    jd = js.DDIMSchedule.create(jsched, 25, "uniform_trailing", 1.0, scale_arr=jnp.asarray(_scale_arr()))
    td = ts.DDIMSchedule.create(tsched, 25, "uniform_trailing", 1.0, scale_arr=_scale_arr())
    np.testing.assert_array_equal(td.scale_arr, np.asarray(jd.scale_arr))
    np.testing.assert_array_equal(td.scale_arr_prev, np.asarray(jd.scale_arr_prev))


# ------------------------------------------------------------------ the model


def jax_standin(jm):
    u = jm.config.unet
    lt, ipf, T = u.text_context_len, u.img_tokens_per_frame, jm.config.video_length

    def apply_model(params, x, t, cond, fs=None, **_):
        ctx, mask = cond["c_crossattn"], cond.get("c_crossattn_mask")
        b, L = ctx.shape[:2]
        if mask is None and L == lt + T * ipf:
            tok, fr = jnp.arange(L - lt), jnp.arange(T)
            per = (tok[None] >= fr[:, None] * ipf) & (tok[None] < (fr[:, None] + 1) * ipf)
            m = jnp.concatenate([jnp.ones((T, lt), bool), per], 1)[None]
        elif mask is None:
            m = jnp.ones((1, 1, L), bool)
        else:
            m = mask[:, None] if mask.ndim == 2 else mask
        m = jnp.broadcast_to(m, (b, T, L)).astype(jnp.float32)[..., None]
        feat = jnp.tanh(((m * ctx[:, None]).sum(2) / m.sum(2)).mean(-1))[:, :, None, None, None]
        out = 0.1 * x * (1 + feat) + 0.05 * cond["c_concat"] + jnp.sin(t / 1000.0)[:, None, None, None, None]
        out = out + 0.01 * fs.astype(jnp.float32)[:, None, None, None, None]
        if cond.get("camera") is not None:
            out = out + 0.1 * jnp.tanh(cond["camera"]["F"]).mean(axis=(1, 2, 3, 4))[:, None, None, None, None]
        return out

    return apply_model


def torch_standin(tm):
    u = tm.config.unet
    lt, ipf, T = u.text_context_len, u.img_tokens_per_frame, tm.config.video_length

    def apply_model(x, t, cond, fs=None, **_):
        ctx, mask = cond["c_crossattn"], cond.get("c_crossattn_mask")
        b, L = ctx.shape[:2]
        if mask is None and L == lt + T * ipf:
            tok, fr = torch.arange(L - lt), torch.arange(T)
            per = (tok[None] >= fr[:, None] * ipf) & (tok[None] < (fr[:, None] + 1) * ipf)
            m = torch.cat([torch.ones(T, lt, dtype=torch.bool), per], 1)[None]
        elif mask is None:
            m = torch.ones(1, 1, L, dtype=torch.bool)
        else:
            m = mask[:, None] if mask.dim() == 2 else mask
        m = m.expand(b, T, L).float()[..., None]
        feat = torch.tanh(((m * ctx[:, None]).sum(2) / m.sum(2)).mean(-1))[:, :, None, None, None]
        out = 0.1 * x * (1 + feat) + 0.05 * cond["c_concat"] + torch.sin(t / 1000.0)[:, None, None, None, None]
        out = out + 0.01 * fs.float()[:, None, None, None, None]
        if cond.get("camera") is not None:
            out = out + 0.1 * torch.tanh(cond["camera"]["F"]).mean(dim=(1, 2, 3, 4))[:, None, None, None, None]
        return out

    return apply_model


# (camera_cfg_scheduler, cfg_interval, CAMC2V_FUSED_CFG)
GUIDED = {"constant": ("constant", None, "0"), "cosine": ("cosine", None, "0"),
          "cosine_interval_inside": ("cosine", (100.0, 700.0), "0"),
          "cosine_interval_outside": ("cosine", (700.0, 999.0), "0"),
          "constant_fused": ("constant", None, "1"), "cosine_fused_interval_inside": ("cosine", (0.0, 600.0), "1")}


@pytest.mark.parametrize("case", list(GUIDED))
def test_guided_evaluation_matches_jax(camcontext, monkeypatch, case):
    """`build_guided_fn` with camera CFG 1.5 (CFG 7.5, rescale 0.7) on a
    CamContextI2V cond (a 3-frame-set context against the single-frame
    uncond, a camera payload) at t = 600, with `apply_model` replaced by the
    same closed form on both sides (the UNet's own numbers are held by the
    3-step `sample` below and the camera files): the CFG and camera-CFG
    combination, the scheduler, the interval's branch, and under
    CAMC2V_FUSED_CFG the padded batch-2B call with the camera-free pass on
    the padded cond. The port's closure is called with the step on the host,
    as the samplers call it."""
    jm, _, tm = camcontext
    sched, interval, fused = GUIDED[case]
    monkeypatch.setenv("CAMC2V_FUSED_CFG", fused)
    monkeypatch.setattr(jm, "apply_model", jax_standin(jm))
    monkeypatch.setattr(tm, "apply_model", torch_standin(tm))
    rng = np.random.default_rng(8)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, c_concat, ctx, uctx, F = f(2, 4, 4, 4, 4), f(2, 4, 4, 4, 4), f(2, 77 + 192, 16), f(2, 77 + 64, 16), f(2, 4, 4, 3, 3)
    fs, t = np.array([3, 5], np.int32), np.array([600, 600], np.int32)
    kw = dict(guidance_scale=7.5, guidance_rescale=0.7, camera_cfg=1.5, camera_cfg_scheduler=sched)

    def jax_fn(x, t, c_concat, ctx, uctx, F, fs, *lo_hi):
        cond = {"c_concat": c_concat, "c_crossattn": ctx, "camera": {"F": F}}
        fn = jm.build_guided_fn(None, cond, dict(cond, c_crossattn=uctx), fs, cfg_interval=lo_hi or None, **kw)
        return fn(x, t)

    bounds = () if interval is None else tuple(jnp.float32(v) for v in interval)
    ref = np.asarray(jit_o0(jax_fn)(*(jnp.asarray(a) for a in (x, t, c_concat, ctx, uctx, F, fs)), *bounds))
    cond = {"c_concat": T_(c_concat), "c_crossattn": T_(ctx), "camera": {"F": T_(F)}}
    fn = tm.build_guided_fn(cond, dict(cond, c_crossattn=T_(uctx)), T_(fs), cfg_interval=interval, **kw)
    got = fn(T_(x), T_(t), 600)
    assert_rel(got.numpy(), ref, 1e-5)
    if interval is not None and not interval[0] <= 600 <= interval[1]:  # outside: the conditional call alone
        np.testing.assert_array_equal(got.numpy(), tm.apply_model(T_(x), T_(t), cond, T_(fs)).numpy())


@pytest.fixture(scope="module")
def dynamicrafter():
    """The TINY DynamiCrafter with `perframe_ae` and `interp_mode` on (JAX
    model, seeded parameter tree, port model)."""
    from test_torch_port_modules import tiny_generation_config

    from camc2v_tpu.models.dynamicrafter import DynamiCrafter as JDC

    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter

    jcfg = dataclasses.replace(tiny_generation_config(), perframe_ae=True, interp_mode=True)
    tm = DynamiCrafter(port_config(jcfg), dtype=torch.float32)
    return JDC(jcfg, dtype=jnp.float32), seeded_params_for(tm, seed=2), tm


def _dc_batch(seed=9):
    rng = np.random.default_rng(seed)
    nb = dict(video=rng.uniform(-1, 1, (2, 4, 32, 32, 3)).astype(np.float32),
              caption_tokens=rng.integers(0, 62, (2, 77)).astype(np.int32), frame_stride=np.array([3, 5], np.int32))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    tb["caption_tokens"] = tb["caption_tokens"].long()
    return {k: jnp.asarray(v) for k, v in nb.items()}, tb


def test_perframe_interp_conditioning_and_decode_match_jax(dynamicrafter):
    """`prepare_batch` with `interp_mode` (every frame encoded, the first and
    last latents in c_concat, zeros between) and `perframe_ae` (the VAE a
    frame at a time), and `decode_first_stage` frame by frame."""
    jm, params, tm = dynamicrafter
    jb, tb = _dc_batch()

    def run(p, batch):
        z, cond = jm.prepare_batch(p, batch, None, need_full_z=False)
        return z, cond["c_concat"], cond["origin_z0"], cond["c_crossattn"], jm.decode_first_stage(p, z)

    ref = [np.asarray(a) for a in jit_o0(run)(params, jb)]
    with torch.no_grad():
        z, cond = tm.prepare_batch(tb, need_full_z=False)
        got = [z, cond["c_concat"], cond["origin_z0"], cond["c_crossattn"], tm.decode_first_stage(z)]
    for g, r in zip(got, ref):
        assert_rel(g.numpy(), r, 1e-4)
    assert (cond["c_concat"][:, 1:-1] == 0).all() and torch.equal(cond["c_concat"][:, 0], z[:, 0])


@pytest.mark.parametrize("uncond", ["zero_embed", "negative_prompt"])
def test_build_uncond_matches_jax(dynamicrafter, monkeypatch, uncond):
    jm, params, tm = dynamicrafter
    monkeypatch.setattr(jm, "config", dataclasses.replace(jm.config, uncond_type=uncond))
    monkeypatch.setattr(tm, "config", dataclasses.replace(tm.config, uncond_type=uncond))
    rng = np.random.default_rng(4)
    ctx = rng.standard_normal((2, 77 + 64, 16)).astype(np.float32)
    neg = rng.integers(0, 62, (2, 77)).astype(np.int32) if uncond == "negative_prompt" else None
    c_concat = np.zeros((2, 4, 4, 4, 4), np.float32)

    def run(p, ctx, *neg_):
        cond = {"c_concat": jnp.asarray(c_concat), "c_crossattn": ctx}
        return jm.build_uncond(p, cond, 2, (32, 32), *neg_)["c_crossattn"]

    ref = np.asarray(jit_o0(run)(params, jnp.asarray(ctx), *(() if neg is None else (jnp.asarray(neg),))))
    with torch.no_grad():
        got = tm.build_uncond({"c_concat": T_(c_concat), "c_crossattn": T_(ctx)}, 2, (32, 32),
                              None if neg is None else T_(neg))["c_crossattn"]
    assert_rel(got.numpy(), ref, 1e-4)
    if uncond == "zero_embed":
        assert (got[:, :77] == 0).all()


@pytest.mark.parametrize("param", ["v", "x0"])
def test_p_losses_targets_match_jax(dynamicrafter, param):
    """`p_losses` for the `v` target with dynamic rescale (z scaled by the
    timestep's `scale_arr` first) and for the `x0` target, with
    `apply_model` replaced by the same closed form on both sides; the JAX
    noise is its key's draw, handed to the port."""
    from camc2v_tpu.models.dynamicrafter import DynamiCrafter as JDC

    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter

    jm0, _, _ = dynamicrafter
    jcfg = dataclasses.replace(jm0.config, parameterization=param, use_dynamic_rescale=param == "v",
                               base_scale=0.6, turning_step=300)
    jm, tm = JDC(jcfg, dtype=jnp.float32), DynamiCrafter(port_config(jcfg), dtype=torch.float32)
    jm.apply_model, tm.apply_model = jax_standin(jm), torch_standin(tm)
    if param == "v":
        np.testing.assert_array_equal(tm.scale_arr, np.asarray(jm.scale_arr))
    rng = np.random.default_rng(10)
    z = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)
    cond = {"c_concat": rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32),
            "c_crossattn": rng.standard_normal((2, 77 + 64, 16)).astype(np.float32)}
    t, fs, key = np.array([120, 870], np.int32), np.array([3, 5], np.int32), jax.random.key(2)
    ref = jit_o0(lambda z, cond, t, key, fs: jm.p_losses(None, z, cond, t, key, fs)[0])(
        jnp.asarray(z), {k: jnp.asarray(v) for k, v in cond.items()}, jnp.asarray(t), key, jnp.asarray(fs))
    noise = T_(jax.random.normal(jax.random.split(key, 3)[0], z.shape, jnp.float32))
    got, _ = tm.p_losses(T_(z), {k: T_(v) for k, v in cond.items()}, T_(t).long(), noise, T_(fs))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


@contextlib.contextmanager
def cleared_self_pair():
    """Both frameworks' adaptor mask (`conditional_epipolar_mask`) with the
    block of the conditioning frame's queries against its own prepended
    pose cleared. That pair's relative pose is inv(c2w) @ c2w, the identity
    up to rounding, so its F is rounding noise (~1e-9) and its mask bits
    differ between any two implementations (ROADMAP §3, "Epipolar mask
    bits"); every other bit agrees exactly."""
    import camc2v_tpu.camera.geometry as JG

    import camc2v_tpu_torch.camera.geometry as TG

    def wrap(real, xp):
        def mask(K, RT, RT_cond, cfi, H, W, downsample=8, config=None):
            m = real(K, RT, RT_cond, cfi, H, W, downsample, config)
            hw = (H // downsample) * (W // downsample)
            q, k = xp.arange(m.shape[1]) // hw, xp.arange(m.shape[2]) // hw
            return m & ~((q[None, :, None] == cfi[:, None, None]) & (k[None, None, :] == 0))
        return mask

    saved = JG.conditional_epipolar_mask, TG.conditional_epipolar_mask
    JG.conditional_epipolar_mask, TG.conditional_epipolar_mask = wrap(saved[0], jnp), wrap(saved[1], torch)
    try:
        yield
    finally:
        JG.conditional_epipolar_mask, TG.conditional_epipolar_mask = saved


def test_prepare_batch_without_the_camera_matches_jax(camcontext):
    """`enable_camera_condition=False` at conditioning frame 2: no camera
    payload; c_concat (whose latent branch still runs on the cameras),
    origin_z0 and the context as in JAX."""
    jm, params, tm = camcontext
    jb, tb = batches(n_ctx=2)

    def run(p, batch):
        z, cond = jm.prepare_batch(p, batch, None, cond_frame_index=jnp.full((2,), 2, jnp.int32),
                                   enable_camera_condition=False, need_full_z=True)
        assert "camera" not in cond
        return cond["c_concat"], cond["origin_z0"], cond["c_crossattn"]

    with cleared_self_pair(), torch.no_grad():
        ref = jit_o0(run)(params, jb)
        z, cond = tm.prepare_batch(tb, cond_frame_index=2, enable_camera_condition=False, need_full_z=True)
    assert "camera" not in cond
    for g, r in zip((cond["c_concat"], cond["origin_z0"], cond["c_crossattn"]), ref):
        assert_rel(g.numpy(), np.asarray(r), 1e-4)


def test_rand_cond_frame_draws_from_the_generator(camcontext):
    """`rand_cond_frame` draws each sample's conditioning frame from the
    caller's generator (the config's flag by default), and the batch is then
    the one of that explicit `cond_frame_index`; without a generator, or
    with the flag off, frame 0."""
    _, _, tm = camcontext
    _, tb = batches(n_ctx=2)
    idx = tm.cond_frame_indices(2, "cpu", torch.Generator().manual_seed(1), rand_cond_frame=True)
    assert idx.tolist() == torch.randint(0, 4, (2,), generator=torch.Generator().manual_seed(1)).tolist()
    assert idx.tolist() != [0, 0]
    assert tm.cond_frame_indices(2, "cpu", None, rand_cond_frame=True).tolist() == [0, 0]
    assert tm.cond_frame_indices(2, "cpu", torch.Generator(), rand_cond_frame=False).tolist() == [0, 0]
    with torch.no_grad():
        _, drawn = tm.prepare_batch(tb, torch.Generator().manual_seed(1), rand_cond_frame=True,
                                    perturb_noise=perturb_draws(2, 4))
        # the posterior sample follows the index draw: the same generator state as the draw left it
        g = torch.Generator().manual_seed(1)
        torch.randint(0, 4, (2,), generator=g)
        _, given = tm.prepare_batch(tb, g, cond_frame_index=idx, perturb_noise=perturb_draws(2, 4))
    assert torch.equal(drawn["c_cond_frame_index"], idx)
    for k in ("c_concat", "c_crossattn"):
        assert torch.equal(drawn[k], given[k]), k
    assert torch.equal(drawn["camera"]["F"], given["camera"]["F"])


def test_guided_loops_never_sync_with_the_host(camcontext, monkeypatch):
    """With camera CFG (cosine) and `cfg_interval`, the DDIM and ancestral
    loops read nothing back to the host: the guided closure gets each step's
    timestep from the loop."""
    _, _, tm = camcontext
    _, tb = batches(n_ctx=2)
    with torch.no_grad():
        z, cond = tm.prepare_batch(tb, prefetch_uncond=True, perturb_noise=perturb_draws(2, 4))
        uc = tm.build_uncond(cond, 2, (32, 32))
    cond.pop("_uncond")
    fn = tm.build_guided_fn(cond, uc, tm.get_fs(tb), guidance_scale=7.5, guidance_rescale=0.7, camera_cfg=1.5,
                            camera_cfg_scheduler="cosine", cfg_interval=(300.0, 900.0))
    ddim = ts.DDIMSchedule.create(tm.schedule, 3, "uniform_trailing", 1.0)
    x_t = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))

    def refuse(*_a, **_k):
        raise AssertionError("host sync inside the sampling loop")

    for name in ("item", "cpu", "numpy", "tolist", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    with torch.no_grad():
        outs = [tsm.ddim_sample(ddim, x_t, fn, generator=torch.Generator().manual_seed(1)),
                tsm.p_sample_loop(tm.schedule, x_t, fn, t_start=2, generator=torch.Generator().manual_seed(1))]
    monkeypatch.undo()
    assert all(o.shape == z.shape and torch.isfinite(o).all() for o in outs)
