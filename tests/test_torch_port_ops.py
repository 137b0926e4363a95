"""The PyTorch port's kernel twins (K1-K4) against the JAX package.

Each twin — what the port's kernel wrapper runs for a CPU tensor — is held
against the JAX plain function and against the JAX Pallas kernel, which runs
in interpret mode on the CPU. Inputs come from numpy with a seed; shapes are
the smallest the Pallas kernels take. The CUDA kernels themselves are held
against these twins on the card by `chip_smoke.py`.

Tolerances:
  * f32 GroupNorm / attention: 1e-5 relative to the output scale (the same
    f32 algorithm, summed in another order);
  * bf16 outputs, and the K3/K4 twins (which round their intermediates to
    bf16 whatever the input dtype): 2 bf16 ulps (2 * 2^-8) of the output
    scale — one ulp for the final rounding, one for an intermediate that
    rounds the other way after a different summation order;
  * K2 against the Pallas kernel in bf16: 4 ulps, because the kernel folds
    the softmax scale into q in bf16 while the plain path scales f32 logits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camc2v_tpu.ops import attention as j_attn
from camc2v_tpu.ops import flash_attention as j_fa
from camc2v_tpu.ops import geglu_ff as j_ff
from camc2v_tpu.ops import groupnorm as j_gn
from camc2v_tpu.ops import temporal_attention as j_ta
from camc2v_tpu_torch.ops import flash_attention as t_fa
from camc2v_tpu_torch.ops import geglu_ff as t_ff
from camc2v_tpu_torch.ops import groupnorm as t_gn
from camc2v_tpu_torch.ops import temporal_attention as t_ta

ULP = 2.0 ** -8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr: np.ndarray, dtype: str):
    """The same numpy values as a JAX array and a torch tensor of `dtype`."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(arr, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _check(got: torch.Tensor, ref, tol_scale: float):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    atol = tol_scale * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,silu", [((2, 4, 8, 64), True), ((2, 3, 4, 4, 64), False)])
def test_groupnorm_twin_matches_jax(dtype, shape, silu):
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    s = rng.normal(1.0, 0.2, shape[-1]).astype(np.float32)
    b = rng.normal(0.0, 0.2, shape[-1]).astype(np.float32)
    jx, tx = _pair(x, dtype)
    kw = dict(num_groups=32, eps=1e-5, silu=silu)
    got = t_gn.group_norm_fused(tx, torch.from_numpy(s), torch.from_numpy(b), **kw)  # CPU -> twin
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "f32" else 2 * ULP
    _check(got, j_gn.group_norm_plain(jx, jnp.asarray(s), jnp.asarray(b), **kw), tol)
    _check(got, j_gn.group_norm_fused(jx, jnp.asarray(s), jnp.asarray(b), **kw), tol)  # Pallas interpret


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_attention_twin_matches_jax(dtype, masked):
    rng = np.random.default_rng(1)
    b, lq, lk, h, d = 1, 256, 100, 2, 16  # Lq one 256-row Pallas tile; Lk padded to 1024 there
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32) for l in (lq, lk, lk))
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    mask = None
    if masked:
        mask = rng.random((b, lq, lk)) < 0.5
        mask[:, np.arange(lq), np.arange(lq) % lk] = True  # no fully masked row
    scale = d ** -0.5
    got = t_fa.flash_attention(tq, tk, tv, mask=None if mask is None else torch.from_numpy(mask), scale=scale)
    jmask = None if mask is None else jnp.asarray(mask)
    tol = 1e-5 if dtype == "f32" else 2 * ULP
    _check(got, j_attn._xla_attention(jq, jk, jv, bias=None, mask=None if jmask is None else jmask[:, None],
                                      scale=scale), tol)
    _check(got, j_fa.flash_attention(jq, jk, jv, mask=jmask, scale=scale),
           1e-5 if dtype == "f32" else 4 * ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ln", [True, False])
def test_temporal_mha_twin_matches_jax(dtype, ln):
    rng = np.random.default_rng(2)
    n, t, c, heads = 16, 16, 32, 2  # 16 sequences = one Pallas block of 2 packed 128-row tiles
    x = rng.normal(size=(n, t, c)).astype(np.float32)
    ws = [rng.normal(0, c ** -0.5, (c, c)).astype(np.float32) for _ in range(4)]  # JAX (in, out)
    bo = rng.normal(0, 0.1, c).astype(np.float32)
    ls = rng.normal(1.0, 0.2, c).astype(np.float32)
    lb = rng.normal(0.0, 0.2, c).astype(np.float32)
    jx, tx = _pair(x, dtype)
    lnkw_t = dict(ln_scale=torch.from_numpy(ls), ln_bias=torch.from_numpy(lb), residual=True) if ln else {}
    lnkw_j = dict(ln_scale=jnp.asarray(ls), ln_bias=jnp.asarray(lb), residual=True) if ln else {}
    got = t_ta.fused_temporal_mha(tx, *(torch.from_numpy(w.T.copy()) for w in ws), torch.from_numpy(bo),
                                  heads=heads, **lnkw_t)
    assert got.dtype == tx.dtype
    jw = [jnp.asarray(w) for w in ws]
    wqkv = jnp.concatenate(jw[:3], axis=1).astype(jnp.bfloat16)
    plain = j_ta._mha_xla(jx, wqkv, jw[3].astype(jnp.bfloat16), jnp.asarray(bo),
                          lnkw_j.get("ln_scale"), lnkw_j.get("ln_bias"), heads=heads, dim_head=c // heads,
                          scale=(c // heads) ** -0.5, residual=ln)
    _check(got, plain, 2 * ULP)
    _check(got, j_ta.fused_temporal_mha(jx, *jw, jnp.asarray(bo), heads=heads, **lnkw_j), 2 * ULP)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_geglu_ff_twin_matches_jax(dtype):
    rng = np.random.default_rng(3)
    rows, c, inner = 128, 32, 128  # one 128-row Pallas tile
    x = rng.normal(size=(2, rows // 2, c)).astype(np.float32)
    ls = rng.normal(1.0, 0.2, c).astype(np.float32)
    lb = rng.normal(0.0, 0.2, c).astype(np.float32)
    wp = rng.normal(0, c ** -0.5, (c, 2 * inner)).astype(np.float32)  # JAX (in, out)
    bp = rng.normal(0, 0.1, 2 * inner).astype(np.float32)
    wf = rng.normal(0, inner ** -0.5, (inner, c)).astype(np.float32)
    bf = rng.normal(0, 0.1, c).astype(np.float32)
    jx, tx = _pair(x, dtype)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = t_ff.fused_ln_geglu_ff(tx, t(ls), t(lb), t(wp.T), t(bp), t(wf.T), t(bf))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    jargs = [jnp.asarray(a) for a in (ls, lb, wp, bp, wf, bf)]
    plain = j_ff._ff_xla(jx.reshape(rows, c), *jargs, inner=inner, eps=1e-5).reshape(x.shape)
    _check(got, plain, 2 * ULP)
    # the Pallas kernel's polynomial erf differs from erff by <= 1.5e-7
    _check(got, j_ff.fused_ln_geglu_ff(jx, *jargs), 2 * ULP)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its twin only for CPU tensors; any other device must
    launch the kernel or raise (here: the meta device)."""
    x = torch.empty(2, 4, 4, 64, device="meta")
    s = torch.empty(64, device="meta")
    with pytest.raises(ValueError):
        t_gn.group_norm_fused(x, s, s)
    q = torch.empty(1, 64, 2, 16, device="meta")
    with pytest.raises(ValueError):
        t_fa.flash_attention(q, q, q)
    xt = torch.empty(4, 16, 32, device="meta")
    w = torch.empty(32, 32, device="meta")
    with pytest.raises(ValueError):
        t_ta.fused_temporal_mha(xt, w, w, w, w, s[:32], heads=2)
    with pytest.raises(ValueError):
        t_ff.fused_ln_geglu_ff(xt, s[:32], s[:32], torch.empty(256, 32, device="meta"), s,
                               torch.empty(32, 128, device="meta"), s[:32])


def test_seams_route_by_device_dtype_and_plain_switch():
    """`ops.route`, the seams' one rule: the kernel for a tensor on the card
    whose dtype it takes (the module's compute dtype when one is given),
    the twin for CPU tensors and inside `plain_twins()` blocks, which nest."""
    from types import SimpleNamespace

    from camc2v_tpu_torch import ops

    card_bf16 = SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    card_f32 = SimpleNamespace(is_cuda=True, dtype=torch.float32)
    assert ops.route(card_bf16)
    assert not ops.route(card_f32)
    assert ops.route(card_f32, takes=(torch.bfloat16, torch.float32))
    assert ops.route(card_f32, torch.bfloat16) and not ops.route(card_bf16, torch.float32)
    assert not ops.route(torch.zeros(1, dtype=torch.bfloat16))
    with ops.plain_twins():
        with ops.plain_twins():
            assert not ops.route(card_bf16)
        assert not ops.route(card_bf16)
    assert ops.route(card_bf16)
