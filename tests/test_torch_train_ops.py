"""The port's kernel seams with gradients, against the JAX package.

K5 and K7, the backward kernels, run only on the card; their plain twins
(`flash_bwd_plain`, `epipolar_bwd_plain`) are what the port's autograd
Functions run for CPU tensors, so the gradients of the port's
`flash_attention` and `epipolar_flash_attention` are held here against
`jax.vjp` of the JAX entry points, whose custom VJPs run the Pallas
backward kernels (`_flash_bwd_impl`, `_epipolar_flash_bwd_impl`) in
interpret mode on the CPU, with their Pallas forwards and logsumexp. The
other seams' Functions (K1, K3, K4: the vjp of the plain twin recomputed)
are held against `jax.grad` of the JAX seams. Inputs come from numpy with a
seed; the K6/K7 geometry is the JAX tests' small one (8x8 frames at ds 8,
64-query and 64-key tiles).

Tolerances, relative to the reference's max |value| per output:
  * f32 attention forward and gradients: 2e-5 (the same f32 algorithm in
    another summation order; observed ~1e-6);
  * K1 f32: 1e-5;
  * K3 and K4, whose twins round their intermediates to bf16 whatever the
    input dtype: 4 bf16 ulps (4 * 2^-8), since a cotangent rounded to bf16
    at a cast can round the other way after another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camc2v_tpu.ops import epipolar_flash as jef
from camc2v_tpu.ops import flash_attention as jfa
from camc2v_tpu.ops import geglu_ff as jff
from camc2v_tpu.ops import groupnorm as jgn
from camc2v_tpu.ops import temporal_attention as jta

from camc2v_tpu_torch.ops import epipolar_flash as tef
from camc2v_tpu_torch.ops import flash_attention as tfa
from camc2v_tpu_torch.ops import geglu_ff as tff
from camc2v_tpu_torch.ops import groupnorm as tgn
from camc2v_tpu_torch.ops import temporal_attention as tta
from test_torch_train_step import one_torch_thread  # noqa: F401  (one torch thread for this module)

ULP = 2.0 ** -8
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


def _made_by(out, function: str) -> bool:
    """The autograd node that made `out`, or the one behind a reshape, is
    the named Function's."""
    node = out.grad_fn
    if type(node).__name__ in ("ViewBackward0", "ReshapeAliasBackward0"):
        node = node.next_functions[0][0]
    return function in type(node).__name__


def _port_vjp(fn, args, cotangent):
    """(out, grads of every input) of the port function at `args` (numpy)."""
    xs = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, torch.from_numpy(np.array(cotangent)))


def _jax_vjp(fn, args, cotangent):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return out, vjp(jnp.asarray(cotangent))


# ------------------------------------------------------------- K2 + K5

B, H, D = 1, 2, 64
FLASH_CASES = [  # (label, Lq, Lk, masked, fully masked rows)
    ("no mask", 256, 1024, False, 0),
    ("mask", 256, 1024, True, 0),
    ("mask, fully masked rows, unpadded Lk", 256, 700, True, 17),
]


@pytest.mark.parametrize("label,lq,lk,masked,dead", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_gradients_match_pallas_backward(label, lq, lk, masked, dead):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, lq, H, D), (B, lk, H, D), (B, lk, H, D)))
    dout = rng.standard_normal((B, lq, H, D)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(B, lq, lk)) > 0.4
        mask[:, :dead] = False
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    ref_out, ref = _jax_vjp(lambda *a: jfa.flash_attention(*a, mask=jmask), (q, k, v), dout)
    out, got = _port_vjp(lambda *a: tfa.flash_attention(*a, mask=tmask), (q, k, v), dout)
    _close(out, ref_out, 2e-5, "out")
    for name, g, r in zip("qkv", got, ref):
        _close(g, r, 2e-5, f"d{name}")
    if dead:
        assert not got[0][:, :dead].any() and not np.asarray(ref[0])[:, :dead].any()


def test_flash_seam_with_grad_runs_the_function():
    """The attention seam sends a call with a head-shared mask through
    `flash_attention`'s Function (its twin on the CPU) with or without a
    gradient; the forward agrees with the plain JAX-numerics path
    `xla_attention` (f32 rounding apart)."""
    from camc2v_tpu_torch.ops.attention import dot_product_attention, xla_attention

    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(rng.uniform(size=(2, 1, 40, 40)) > 0.3) | torch.eye(40, dtype=torch.bool)
    with torch.no_grad():
        plain = dot_product_attention(q, k, v, mask=mask)
    qg = q.clone().requires_grad_()
    out = dot_product_attention(qg, k, v, mask=mask)
    assert _made_by(out, "Flash")
    _close(out, plain.numpy(), 2e-6)
    _close(out, xla_attention(q, k, v, mask=mask, scale=16 ** -0.5).numpy(), 2e-6)


# ------------------------------------------------------------- K6 + K7

T, HH, WW, DS, R = 4, 8, 8, 8, 4
HW = HH * WW
BQ = BK = 64


def _small_F(t1, t2, seed, zero_pair=None):
    """F from a camera trajectory with distinct translations (the JAX tests'
    small geometry), optionally with one frame pair's F zeroed."""
    from camc2v_tpu.camera import geometry as JG

    rng = np.random.default_rng(seed)
    K = np.array([[HH * DS, 0, HH * DS / 2], [0, WW * DS, WW * DS / 2], [0, 0, 1]], np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, max(t1, t2), 1, 1))
    for i in range(max(t1, t2)):
        c2w[0, i, :3, 3] = [0.4 * i + 0.05, 0.1 * i, -0.15 * i]
    c2w[0, :, :3, 3] += 0.02 * rng.standard_normal((max(t1, t2), 3))
    pairs = JG.relative_c2w_pairs(jnp.asarray(c2w))[:, :t1, :t2]
    tv = JG.add_small_perturbation(pairs[..., :3, 3:4], jax.random.key(1))
    F = np.array(JG.fundamental_matrix(jnp.broadcast_to(jnp.asarray(K), (1, t1, t2, 3, 3)), pairs[..., :3, :3], tv))
    if zero_pair is not None:
        F[:, zero_pair[0], zero_pair[1]] = 0.0
    return F


EPI_CASES = [  # (label, query frames, key frames, heads, zeroed frame pair)
    ("ds8-like, registers, one zero-F pair", T, T, 2, (1, 2)),
    ("adaptor-like, Lq != t*hw", 4, 3, 2, (0, 0)),
]


@pytest.mark.parametrize("label,tq,tk,heads,zero", EPI_CASES, ids=[c[0] for c in EPI_CASES])
def test_epipolar_gradients_match_pallas_backward(label, tq, tk, heads, zero):
    F = _small_F(tq, tk, seed=2, zero_pair=zero)
    lines = np.asarray(jef.epipolar_lines(jnp.asarray(F), HH, WW, DS))  # (1, tq*HW, tk, 3)
    assert np.isnan(lines).any()
    lq, lk = tq * HW, tk * HW + R
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, lq, heads, 64)).astype(np.float32)
    k, v = (rng.standard_normal((1, lk, heads, 64)).astype(np.float32) for _ in range(2))
    dout = rng.standard_normal((1, lq, heads, 64)).astype(np.float32)
    geom = dict(t=tk, h=HH, w=WW, downsample=DS, num_registers=R, block_q=BQ, block_k=BK)
    pad = np.zeros((1, BK - R, heads, 64), np.float32)  # the Pallas layout pads the registers to a key tile

    def jax_fn(q_, k_, v_):
        kp, vp = (jnp.concatenate([a, jnp.asarray(pad)], axis=1) for a in (k_, v_))
        return jef.epipolar_flash_attention(q_, kp, vp, jnp.asarray(lines), **geom)

    ref_out, ref = _jax_vjp(jax_fn, (q, k, v), dout)
    out, got = _port_vjp(lambda *a: tef.epipolar_flash_attention(*a, T_(lines), **geom), (q, k, v), dout)
    _close(out, ref_out, 2e-5, "out")
    for name, g, r in zip("qkv", got, ref):
        _close(g, r, 2e-5, f"d{name}")


# --------------------------------------------------------- K1, K3, K4

def test_groupnorm_seam_gradient_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0.5, 2.0, (2, 3, 4, 4, 64)).astype(np.float32)
    s, b = rng.normal(1.0, 0.2, 64).astype(np.float32), rng.normal(0.0, 0.2, 64).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    kw = dict(num_groups=32, eps=1e-5, silu=True)
    ref_out, ref = _jax_vjp(lambda *a: jgn.group_norm_fused(*a, **kw), (x, s, b), g)
    out, got = _port_vjp(lambda *a: tgn.group_norm(*a, **kw), (x, s, b), g)
    assert _made_by(out, "Recompute")
    _close(out, ref_out, 1e-5)
    for name, gg, r in zip(("x", "scale", "bias"), got, ref):
        _close(gg, r, 1e-5, name)


@pytest.mark.parametrize("ln", [True, False])
def test_temporal_mha_seam_gradient_matches_jax(ln):
    rng = np.random.default_rng(2)
    n, t, c, heads = 16, 16, 32, 2
    x = rng.normal(size=(n, t, c)).astype(np.float32)
    ws = [rng.normal(0, c ** -0.5, (c, c)).astype(np.float32) for _ in range(4)]  # JAX (in, out)
    bo = rng.normal(0, 0.1, c).astype(np.float32)
    ls, lb = rng.normal(1.0, 0.2, c).astype(np.float32), rng.normal(0.0, 0.2, c).astype(np.float32)
    g = rng.standard_normal((n, t, c)).astype(np.float32)
    args = [x, *ws, bo] + ([ls, lb] if ln else [])

    def jax_fn(x_, wq, wk, wv, wo, bo_, *lnp):
        kw = dict(ln_scale=lnp[0], ln_bias=lnp[1], residual=True) if ln else {}
        return jta.fused_temporal_mha(x_, wq, wk, wv, wo, bo_, heads=heads, **kw)

    def port_fn(x_, wq, wk, wv, wo, bo_, *lnp):
        kw = dict(ln_scale=lnp[0], ln_bias=lnp[1], residual=True) if ln else {}
        return tta.fused_temporal_mha(x_, wq.t(), wk.t(), wv.t(), wo.t(), bo_, heads=heads, **kw)

    ref_out, ref = _jax_vjp(jax_fn, args, g)
    out, got = _port_vjp(port_fn, args, g)
    assert _made_by(out, "Recompute")
    _close(out, ref_out, 4 * ULP)
    for i, (gg, r) in enumerate(zip(got, ref)):
        _close(gg, r, 4 * ULP, f"input {i}")


def test_geglu_ff_seam_gradient_matches_jax():
    rng = np.random.default_rng(3)
    rows, c, inner = 128, 32, 128
    x = rng.normal(size=(2, rows // 2, c)).astype(np.float32)
    ls, lb = rng.normal(1.0, 0.2, c).astype(np.float32), rng.normal(0.0, 0.2, c).astype(np.float32)
    wp = rng.normal(0, c ** -0.5, (c, 2 * inner)).astype(np.float32)  # JAX (in, out)
    bp = rng.normal(0, 0.1, 2 * inner).astype(np.float32)
    wf = rng.normal(0, inner ** -0.5, (inner, c)).astype(np.float32)
    bf = rng.normal(0, 0.1, c).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    args = (x, ls, lb, wp, bp, wf, bf)
    ref_out, ref = _jax_vjp(jff.fused_ln_geglu_ff, args, g)
    out, got = _port_vjp(lambda x_, ls_, lb_, wp_, bp_, wf_, bf_: tff.fused_ln_geglu_ff(
        x_, ls_, lb_, wp_.t(), bp_, wf_.t(), bf_), args, g)
    assert _made_by(out, "Recompute")
    _close(out, ref_out, 4 * ULP)
    for i, (gg, r) in enumerate(zip(got, ref)):
        _close(gg, r, 4 * ULP, f"input {i}")


# ----------------------------------------------------------------- rules

def test_bare_launches_refuse_inputs_that_need_a_gradient():
    """A kernel launch writes a tensor outside the autograd graph, so every
    wrapper goes through its autograd.Function (whose forward and backward
    run with grad mode off), with or without a gradient, and a launch in
    grad mode raises before touching the device (`_build.load`)."""
    from camc2v_tpu_torch.ops import _build

    for name in _build.KERNELS:
        with pytest.raises(RuntimeError, match="grad mode"):
            _build.load(name)
    rng = np.random.default_rng(9)
    T_ = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()  # noqa: E731
    x, w, q = T_(2, 16, 32), T_(32, 32), T_(1, 256, 2, 16)
    kv = T_(1, 2 * 64 + 2, 2, 16)
    lines = torch.from_numpy(rng.standard_normal((1, 256, 2, 3)).astype(np.float32))
    calls = {
        "Recompute": [
            lambda: tgn.group_norm_fused(T_(2, 4, 4, 64), T_(64), T_(64)),
            lambda: tta.fused_temporal_mha(x, w, w, w, w, T_(32), heads=2),
            lambda: tff.fused_ln_geglu_ff(x, T_(32), T_(32), T_(256, 32), T_(256), T_(32, 128), T_(32)),
        ],
        "Flash": [lambda: tfa.flash_attention(q, q, q)],
        "Epipolar": [lambda: tef.epipolar_flash_attention(q, kv, kv, lines, t=2, h=8, w=8, downsample=8,
                                                                   num_registers=2, block_q=64, block_k=64)],
    }
    for function, fns in calls.items():
        for fn in fns:
            assert _made_by(fn(), function)
            with torch.no_grad():
                assert fn().grad_fn is None
