"""The port's opt-in-route kernels' twins and seams against the JAX package.

K8 (fused LayerNorm), K9 (two-phase GroupNorm), K10 (one-launch two-phase
GroupNorm) and K6p (epipolar attention on precomputed penalties) run only on
the card; on the CPU their wrappers run the plain twins, which are held here
against the JAX entry points, whose Pallas kernels run in interpret mode on
the CPU (`layer_norm_fused`, `group_norm_fused_temporal`,
`group_norm_fused_big`, `epipolar_flash_attention(penalties=)`), with inputs
drawn from numpy with a seed. Also here: the seams' gradients against
`jax.grad`, `materialize_penalties` and `add_precomputed_penalties` against
the JAX functions, the `Epipolar` module with and without penalties, the
norm sites' route choice against the JAX predicates, `dpmpp_2m_sample`
against JAX's, and `sample`'s keyword defaults against JAX's.

Tolerances, relative to the reference's max |value|:
  * f32: 1e-5 for the norms, 2e-5 for attention (the same f32 algorithm in
    another summation order; observed ~1e-6); gradients 1e-4 (the JAX
    backward recomputes the two-pass twin, as the port's does);
  * bf16 norms: 4 bf16 ulps (4 * 2^-8): the f32 statistics agree to ~1e-6,
    and an output can round to the neighbouring bf16 value;
  * penalties: equal except near-threshold bits (`assert_near_threshold_only`,
    the JAX lines' own distances in f64 within 1e-4 of the threshold).
"""

import inspect
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_geometry import B, BK, BQ, DS, HW, LQ, R, T, W, _small_F, assert_near_threshold_only  # noqa: E402
from test_torch_camera_geometry import H as FH  # noqa: E402
from test_torch_camera_modules import _F  # noqa: E402
from test_torch_port_modules import _normal, assert_close, jax_params, run_both  # noqa: E402
from test_torch_train_step import one_torch_thread  # noqa: E402,F401  (one torch thread for this module)

from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402
from camc2v_tpu.ops import groupnorm as jgn  # noqa: E402
from camc2v_tpu.ops import layernorm as jln  # noqa: E402

from camc2v_tpu_torch import config as pc  # noqa: E402
from camc2v_tpu_torch import ops  # noqa: E402
from camc2v_tpu_torch.nn import layers as tl  # noqa: E402
from camc2v_tpu_torch.ops import epipolar_flash as tef  # noqa: E402
from camc2v_tpu_torch.ops import groupnorm as tgn  # noqa: E402
from camc2v_tpu_torch.ops import layernorm as tln  # noqa: E402

ULP = 2.0 ** -8
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


def _norm_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    c = shape[-1]
    return x, (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32)


def _both_dtypes(x, dtype):
    """(JAX array, torch tensor) of x in `dtype` ("f32" or "bf16"), the same
    values on both sides."""
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    return jx, T_(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


# ------------------------------------------------------------------- K8

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k8_twin_matches_pallas_interpret(dtype):
    x, s, b = _norm_inputs((32, 48, 320), 11)
    jx, tx = _both_dtypes(x, dtype)
    ref = jln.layer_norm_fused(jx, jnp.asarray(s), jnp.asarray(b), eps=1e-5)
    got = tln.layer_norm_fused(tx, T_(s), T_(b), eps=1e-5)
    assert got.dtype == tx.dtype
    _close(got, np.asarray(ref.astype(jnp.float32)), 1e-5 if dtype == "f32" else 4 * ULP, dtype)


# ----------------------------------------------------------- K9 and K10

# (label, shape): a 5-D temporal norm and a VAE-style 4-D map viewed as
# (N, s, H/s*W, C), the GN_BIG4D layout
GN_CASES = [("5-D", (2, 4, 8, 8, 128)), ("4-D view", (2, 4, 64, 128))]


@pytest.mark.parametrize("entry", ["temporal", "big"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("label,shape", GN_CASES, ids=[c[0] for c in GN_CASES])
def test_k9_k10_twins_match_pallas_interpret(label, shape, dtype, silu, entry):
    x, s, b = _norm_inputs(shape, 5)
    jx, tx = _both_dtypes(x, dtype)
    jfn = jgn.group_norm_fused_temporal if entry == "temporal" else jgn.group_norm_fused_big
    tfn = tgn.group_norm_fused_temporal if entry == "temporal" else tgn.group_norm_fused_big
    ref = jfn(jx, jnp.asarray(s), jnp.asarray(b), num_groups=32, silu=silu)
    got = tfn(tx, T_(s), T_(b), num_groups=32, silu=silu)
    _close(got, np.asarray(ref.astype(jnp.float32)), 1e-5 if dtype == "f32" else 4 * ULP, f"{label} {dtype}")


# ------------------------------------------------------------ gradients

def _grads_match(tfn, jfn, x, s, b, tol=1e-4):
    cot = _normal(*x.shape, seed=3)
    xs = [T_(a).requires_grad_() for a in (x, s, b)]
    out = tfn(*xs)
    got = torch.autograd.grad(out, xs, T_(cot))
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    for name, g, r in zip(("x", "scale", "bias"), got, vjp(jnp.asarray(cot))):
        _close(g, r, tol, name)


@pytest.mark.parametrize("seam", ["layernorm", "temporal", "big"])
def test_route_seam_gradients_match_jax(seam):
    if seam == "layernorm":
        x, s, b = _norm_inputs((4, 24, 256), 2)
        _grads_match(lambda *a: tln.layer_norm_fused(*a), lambda *a: jln.layer_norm_fused(*a), x, s, b)
        return
    x, s, b = _norm_inputs((2, 4, 4, 4, 128), 4)
    tfn = tgn.group_norm_fused_temporal if seam == "temporal" else tgn.group_norm_fused_big
    jfn = jgn.group_norm_fused_temporal if seam == "temporal" else jgn.group_norm_fused_big
    _grads_match(lambda *a: tfn(*a, silu=True), lambda *a: jfn(*a, silu=True), x, s, b)


# ------------------------------------------------------------------ K6p

def test_materialize_penalties_match_jax():
    lines = jef.epipolar_lines(_small_F(), FH, W, DS)
    ref = np.asarray(jef.materialize_penalties(lines, T, FH, W, DS, R, BK).astype(jnp.float32))
    got = tef.materialize_penalties(T_(lines), T, FH, W, DS)
    assert got.dtype == torch.bfloat16 and got.shape == (B, LQ, LQ)
    # the JAX array's trailing tile: the registers visible, the padding hidden
    np.testing.assert_array_equal(ref[..., LQ:LQ + R], 0.0)
    assert (ref[..., LQ + R:] < -1e29).all()
    got = got.float().numpy()
    assert set(np.unique(got)) <= {0.0, torch.tensor(-1e30, dtype=torch.bfloat16).item()}
    assert_near_threshold_only(got == 0, ref[..., :LQ] == 0, np.asarray(lines), FH, W, DS, "penalties")


@pytest.mark.parametrize("pb", [2, 1], ids=["pb=b", "pb=1 shared"])
@pytest.mark.parametrize("block_k", [BK, 4 * HW], ids=["frame tiles", "multi-frame tile"])
def test_k6p_twin_matches_pallas_interpret(pb, block_k):
    """K6p's twin against the Pallas `_v2p_kernel` (interpret mode) on the
    same penalties, at batch 2: penalties per sample, or one copy read by
    both samples (the fused-CFG layout)."""
    b = 2
    lines1 = jef.epipolar_lines(_small_F(), FH, W, DS)
    F2 = _small_F(np.eye(T, dtype=bool))  # the second sample: zero-F diagonal, NaN lines
    lines = jnp.concatenate([lines1, jef.epipolar_lines(F2, FH, W, DS)])[:b] if pb == 2 else \
        jnp.concatenate([lines1, lines1])
    jpen = jef.materialize_penalties(lines[:pb], T, FH, W, DS, R, block_k)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((b, LQ, 2, 64)).astype(np.float32)
    kv = rng.standard_normal((2, b, LQ + R, 2, 64)).astype(np.float32)
    k, v = (np.concatenate([a, np.zeros((b, block_k - R, 2, 64), np.float32)], axis=1) for a in kv)
    geom = dict(t=T, h=FH, w=W, downsample=DS, num_registers=R)
    tiles = jef.epipolar_tile_map(lines, T, FH, W, DS, BQ, block_k)
    ref = np.asarray(jef._epipolar_flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lines, tiles, jpen, scale=0.125, block_q=BQ,
        block_k=block_k, **geom))
    # the port's penalties: the JAX array's frame columns (the same bf16 values)
    tpen = T_(np.asarray(jpen[..., :LQ].astype(jnp.float32))).to(torch.bfloat16)
    got = tef.epipolar_flash_attention(T_(q), T_(kv[0]), T_(kv[1]), T_(lines), block_q=BQ, block_k=block_k,
                                       penalties=tpen, **geom)
    assert np.isfinite(ref).all()
    _close(got, ref, 2e-5)
    # and the in-kernel-mask path on the same lines gives the same attention
    inkernel = tef.epipolar_flash_attention(T_(q), T_(kv[0]), T_(kv[1]), T_(lines), block_q=BQ, block_k=block_k,
                                            **geom)
    _close(got, inkernel.numpy(), 2e-5, "penalties vs lines")


def test_k6p_gradient_is_the_line_masks():
    """With a gradient wanted, the penalties' forward keeps the in-kernel
    path's backward (the JAX custom VJP recomputes on the lines' mask)."""
    lines = T_(jef.epipolar_lines(_small_F(), FH, W, DS))
    pen = tef.materialize_penalties(lines, T, FH, W, DS)
    rng = np.random.default_rng(1)
    args = [T_(rng.standard_normal(s).astype(np.float32)) for s in ((1, LQ, 2, 64), (1, LQ + R, 2, 64),
                                                                     (1, LQ + R, 2, 64))]
    cot = T_(rng.standard_normal((1, LQ, 2, 64)).astype(np.float32))
    geom = dict(t=T, h=FH, w=W, downsample=DS, num_registers=R, block_q=BQ, block_k=BK)
    grads = []
    for p in (pen, None):
        xs = [a.clone().requires_grad_() for a in args]
        out = tef.epipolar_flash_attention(*xs, lines, penalties=p, **geom)
        grads.append(torch.autograd.grad(out, xs, cot))
    for g, r in zip(*grads):
        _close(g, r.numpy(), 2e-5)


def test_k6p_wrapper_rejects_other_penalty_layouts():
    lines = torch.zeros(2, LQ, T, 3)
    q = torch.zeros(2, LQ, 2, 64)
    k = torch.zeros(2, LQ + R, 2, 64)
    geom = dict(t=T, h=FH, w=W, downsample=DS, num_registers=R, block_q=BQ, block_k=BK)
    for bad in (torch.zeros(2, LQ, LQ + BK), torch.zeros(3, LQ, LQ), torch.zeros(LQ, LQ)):
        with pytest.raises(ValueError, match="penalties"):
            tef.epipolar_flash_attention(q, k, k, lines, penalties=bad, **geom)


def test_add_precomputed_penalties_gating(monkeypatch):
    from camc2v_tpu.nn import epipolar as jep

    from camc2v_tpu_torch.nn import epipolar as tep

    kw = dict(origin_h=FH * DS * 2, origin_w=W * DS * 2, attention_resolution=(1, 2), num_register_tokens=R)
    F = _F(T, FH * DS * 2)
    jprep = jep.prepare_plain_epipolar(F, jep.EpipolarConfig(**kw))
    tprep = tep.prepare_plain_epipolar(T_(F), pc.EpipolarConfig(**kw))
    assert sorted(tprep) == sorted(jprep) == [8, 16] and "tile_any" in tprep[8] and "tile_any" not in tprep[16]
    monkeypatch.delenv("CAMC2V_EPI_PRECOMP", raising=False)
    assert tep.add_precomputed_penalties(tprep, pc.EpipolarConfig(**kw), T) is tprep
    monkeypatch.setenv("CAMC2V_EPI_PRECOMP", "0")
    assert tep.add_precomputed_penalties(tprep, pc.EpipolarConfig(**kw), T) is tprep
    monkeypatch.setenv("CAMC2V_EPI_PRECOMP", "1")
    for cap in (None, 1):
        jaug = jep.add_precomputed_penalties(jprep, jep.EpipolarConfig(**kw), T, max_level_bytes=cap)
        taug = tep.add_precomputed_penalties(tprep, pc.EpipolarConfig(**kw), T, max_level_bytes=cap)
        for ds in (8, 16):
            assert ("penalties" in taug[ds]) == ("penalties" in jaug[ds]) == (cap is None and ds == 8)
        assert "penalties" not in tprep[8]  # the input prep is left as it was
    pen = tep.add_precomputed_penalties(tprep, pc.EpipolarConfig(**kw), T)[8]["penalties"]
    jpen = np.asarray(jep.add_precomputed_penalties(jprep, jep.EpipolarConfig(**kw), T)[8]["penalties"]
                      .astype(jnp.float32))
    assert pen.dtype == torch.bfloat16 and pen.shape == (1, T * 16 * 16, T * 16 * 16)
    assert_near_threshold_only(pen.float().numpy() == 0, jpen[..., :T * 256] == 0, np.asarray(jprep[8]["lines"]),
                               16, 16, 8, "prep penalties")


def test_epipolar_module_with_penalties_matches_jax(monkeypatch):
    """`Epipolar` at a kernel-tiled level (16x16 frames at ds8) with the
    request's prep carrying penalties, port and JAX, and against the port
    without penalties."""
    from camc2v_tpu.nn import epipolar as jep

    from camc2v_tpu_torch.nn import epipolar as tep

    monkeypatch.setenv("CAMC2V_EPI_PRECOMP", "1")
    t, c, heads, hw = 4, 64, 2, 16
    kw = dict(origin_h=8 * hw, origin_w=8 * hw, attention_resolution=(1,), num_register_tokens=R)
    F = _F(t, 8 * hw)
    feats = _normal(1, t, hw, hw, c)
    jprep = jep.add_precomputed_penalties(jep.prepare_plain_epipolar(F, jep.EpipolarConfig(**kw)),
                                          jep.EpipolarConfig(**kw), t)
    tprep = tep.add_precomputed_penalties(tep.prepare_plain_epipolar(T_(F), pc.EpipolarConfig(**kw)),
                                          pc.EpipolarConfig(**kw), t)
    assert "penalties" in jprep[8] and "penalties" in tprep[8]
    jm = jep.Epipolar(config=jep.EpipolarConfig(**kw), query_dim=c, heads=heads)
    params = jax_params(jm, jnp.asarray(feats), F=F)
    assert float(np.abs(params["epipolar_attn"]["to_out"]["kernel"]).min()) > 0
    tm = tep.Epipolar(pc.EpipolarConfig(**kw), c, heads)
    got, ref = run_both(jm, params, tm, [feats], jkw=dict(F=F, prep=jprep), tkw=dict(F=T_(F), prep=tprep))
    assert_close(got, ref)
    with torch.no_grad():
        plain = tm(T_(feats), F=T_(F), prep={8: {k: v for k, v in tprep[8].items() if k != "penalties"}})
    assert_close(got, plain.numpy())


# ---------------------------------------------------------- route choice

def _jax_gn_site(x, groups, temporal, big4d):
    """The JAX GroupNorm32's branch (camc2v_tpu/nn/layers.py:102-146) on its
    TPU backend, from the JAX predicates."""
    if jgn.group_norm_supported(x, groups):
        return "two_pass", 0
    if x.ndim >= 5 and jgn.group_norm_temporal_supported(x, groups) and temporal:
        return "temporal", 0
    if x.ndim == 4 and big4d:
        n, h, w, c = x.shape
        for s in range(2, h + 1):
            if h % s == 0 and jgn.group_norm_temporal_supported(
                    jax.ShapeDtypeStruct((n, s, (h // s) * w, c), x.dtype), groups):
                return "big4d", s
    return "two_pass", 0


# the flagship's norm sites (UNet 5-D temporal norms at each level, frame-wise
# 4-D norms, the VAE's maps at 32..256) plus shapes at the predicates' edges
GN_SHAPES = [(2, 16, 32, 32, 320), (2, 16, 16, 16, 640), (2, 16, 8, 8, 1280), (2, 16, 4, 4, 1280),
             (32, 32, 32, 320), (32, 8, 8, 1280), (16, 32, 32, 512), (16, 64, 64, 512), (16, 128, 128, 256),
             (16, 256, 256, 128), (3, 256, 256, 128), (1, 16, 24, 24, 96), (16, 60, 60, 128), (4, 7, 9, 256)]
LN_SHAPES = [(32, 1024, 320), (2, 16384, 64), (2, 77, 1024), (4, 257, 1280), (8, 256, 640), (16, 1280),
             (3, 5, 128), (1024, 2048), (7, 1280)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_norm_route_choice_matches_jax_predicates(dtype, monkeypatch):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    for temporal in ("0", "1"):
        for big4d in ("0", "1"):
            monkeypatch.setenv("CAMC2V_GN_TEMPORAL", temporal)
            monkeypatch.setenv("CAMC2V_GN_BIG4D", big4d)
            for shape in GN_SHAPES:
                x = torch.empty(shape, dtype=dtype, device="meta")
                groups = tl.GroupNorm32(shape[-1]).num_groups
                want = _jax_gn_site(jax.ShapeDtypeStruct(shape, jdt), groups, temporal == "1", big4d == "1")
                assert tl.group_norm_site(x, groups) == want, (shape, temporal, big4d)
    for shape in LN_SHAPES:
        x = torch.empty(shape, dtype=dtype, device="meta")
        assert tln.layer_norm_supported(x) == jln.layer_norm_supported(jax.ShapeDtypeStruct(shape, jdt)), shape
    # the flagship's sites that the switches hand to K9, and one that stays on K1
    monkeypatch.setenv("CAMC2V_GN_TEMPORAL", "1")
    monkeypatch.setenv("CAMC2V_GN_BIG4D", "1")
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")  # noqa: E731
    assert tl.group_norm_site(meta(2, 16, 32, 32, 320), 32) == ("temporal", 0)
    assert tl.group_norm_site(meta(16, 256, 256, 128), 32) == ("big4d", 16)
    assert tl.group_norm_site(meta(2, 16, 4, 4, 1280), 32) == ("two_pass", 0)


def test_norm_switches_leave_cpu_tensors_on_the_two_pass_twins(monkeypatch):
    """On the CPU the norms ignore their switches, as the JAX package does on
    its CPU backend: GroupNorm32 and LayerNormF32 give what they give with
    the switches off."""
    x5 = T_(_normal(2, 4, 8, 8, 128) * 3 + 1)
    x3 = T_(_normal(4, 16, 256))
    gn, ln = tl.GroupNorm32(128), tl.LayerNormF32(256)
    with torch.no_grad():
        off = gn(x5, silu=True), ln(x3)
        for name in ("CAMC2V_GN_TEMPORAL", "CAMC2V_GN_BIG4D", "CAMC2V_LN_FUSED"):
            monkeypatch.setenv(name, "1")
        on = gn(x5, silu=True), ln(x3)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert ops.switch_on("CAMC2V_LN_FUSED") and not ops.switch_on("CAMC2V_NOT_A_SWITCH")


# --------------------------------------------------------------- sampler

def test_dpmpp_2m_sample_matches_jax():
    """The DPM++(2M) loop on a toy denoiser (linear in x, t-dependent) over
    the 13- and 4-step uniform_trailing tables: first order first, second
    order in the middle, first order last for tables under 15 steps."""
    from camc2v_tpu.core.schedules import DDIMSchedule as JDDIM
    from camc2v_tpu.core.schedules import DiffusionSchedule as JSched
    from camc2v_tpu.models.sampler import dpmpp_2m_sample as jdpm

    from camc2v_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule
    from camc2v_tpu_torch.models.sampler import dpmpp_2m_sample

    x_t = _normal(2, 3, 4, 4, 4, seed=7)
    w = _normal(4, 4, seed=8) * 0.3
    for steps in (13, 4):
        jd = JDDIM.create(JSched.create(), steps, "uniform_trailing", 1.0)
        td = DDIMSchedule.create(DiffusionSchedule.create(), steps, "uniform_trailing", 1.0)
        np.testing.assert_array_equal(np.asarray(jd.timesteps), td.timesteps)
        ref = np.asarray(jdpm(jax.random.key(0), jd, jnp.asarray(x_t),
                              lambda x, t: jnp.tanh(x @ w) * (t[:, None, None, None, None] / 1000.0)))
        got = dpmpp_2m_sample(td, T_(x_t), lambda x, t, step: torch.tanh(x @ T_(w)) * (t[:, None, None, None, None] / 1000.0))
        assert_close(got.numpy(), ref)


def test_sample_defaults_match_jax():
    """`sample` takes every keyword of the JAX package's, with its default;
    the only differences: the JAX `params` and `rng` (the port's weights live
    in the module, its draws come from `generator`) and the port's test hooks."""
    from camc2v_tpu.models.dynamicrafter import DynamiCrafter as JDC

    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter as TDC

    jsig, tsig = inspect.signature(JDC.sample).parameters, inspect.signature(TDC.sample).parameters
    jkw = {n: p.default for n, p in jsig.items() if n not in ("self", "params", "batch", "rng")}
    tkw = {n: p.default for n, p in tsig.items() if n not in ("self", "batch", "generator", "x_T", "step_noise",
                                                                "perturb_noise")}
    assert tkw == jkw
    assert all(tsig[n].kind == tsig[n].KEYWORD_ONLY for n in tkw) and tsig["generator"].default is None
