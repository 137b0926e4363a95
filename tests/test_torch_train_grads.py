"""Two costly gradient checks against the JAX package, in a file of three
tests so that xdist (`--dist loadfile`, files queued by their number of
tests, most first) runs them beside `tests/test_tp.py` rather than before
it. Moved unchanged, names kept:

  * from `test_torch_train_run.py`: `test_padded_loss_and_gradients_match_jax`
    (the padded CamContextI2V loss and trainable gradients against the JAX
    package's padded path under `jax.value_and_grad`, within 1e-4 of each
    output's max |value|);
  * from `test_torch_train_ops.py`: `test_temporal_mha_seam_gradient_matches_jax`
    (K3's seam gradient against `jax.grad` of the JAX seam, within 4 bf16
    ulps), with and without the LayerNorm.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, perturb_draws  # noqa: E402
from test_torch_port_modules import flat  # noqa: E402
from test_torch_train_ops import ULP, _close, _jax_vjp, _made_by, _port_vjp  # noqa: E402
from test_torch_train_run import camcontext, pad  # noqa: E402,F401
from test_torch_train_step import PATTERNS, one_torch_thread  # noqa: E402,F401

from camc2v_tpu.ops import temporal_attention as jta  # noqa: E402

from camc2v_tpu_torch.ops import temporal_attention as tta  # noqa: E402
from camc2v_tpu_torch.utils.weights import _to_torch_layout, jax_to_torch_name  # noqa: E402


def test_padded_loss_and_gradients_match_jax(camcontext, monkeypatch):
    """n = 2 context frames in 4 slots: the loss and the trainable gradients
    against the JAX package's padded path, on the same weights and inputs.
    The JAX program is compiled at XLA's lowest backend optimisation level,
    which cuts its compile time and keeps its f32 arithmetic."""
    from camc2v_tpu.core.schedules import q_sample
    from camc2v_tpu.parallel.trainer import param_labels

    from camc2v_tpu_torch.ops import flash_attention as fa

    jm, params, tm = camcontext
    jb, tb = batches(n_ctx=2)
    jb, tb = pad(jb), pad(tb)
    t = np.array([37, 911], np.int32)
    noise = np.random.default_rng(7).standard_normal((2, 4, 4, 4, 4)).astype(np.float32)

    def loss_fn(p):
        z, cond = jm.prepare_batch(p, jb, None, need_full_z=True)
        x_noisy = q_sample(jm.schedule, z, jnp.asarray(t), jnp.asarray(noise))
        out = jm.apply_model(p, x_noisy, jnp.asarray(t), cond, jm.get_fs(jb), deterministic=True)
        return jm.get_loss(out, jnp.asarray(noise)).mean(axis=(1, 2, 3, 4)).mean()

    labels = param_labels(params, PATTERNS)
    split = lambda keep: jax.tree_util.tree_map(lambda lab, p: p if lab == keep else None, labels, params)  # noqa
    merge = lambda a, b: jax.tree_util.tree_map(lambda x, y: y if x is None else x, a, b,  # noqa: E731
                                                is_leaf=lambda x: x is None)
    args = (split("train"), split("freeze"))
    program = jax.jit(jax.value_and_grad(lambda tr, fr: loss_fn(merge(tr, fr)))).lower(*args).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    jloss, jgrads = program(*args)
    jgrads = {jax_to_torch_name(k): _to_torch_layout(k, v) for k, v in flat(jgrads).items() if v.dtype != object}

    masked_with_grad = []
    real_apply = fa._Flash.apply

    def recorded(q, k, v, mask, scale, kernel, tiles):
        masked_with_grad.append(mask is not None and q.requires_grad)
        return real_apply(q, k, v, mask, scale, kernel, tiles)

    monkeypatch.setattr(fa._Flash, "apply", recorded)
    names = [n for n, _ in tm.named_parameters() if n in {jax_to_torch_name(k) for k in jgrads}]
    named = dict(tm.named_parameters())
    for n, p in named.items():
        p.requires_grad_(n in names)
    try:
        z, cond = tm.prepare_batch(tb, None, need_full_z=True, perturb_noise=perturb_draws(2, 4))
        loss, _ = tm.p_losses(z, cond, torch.from_numpy(t).long(), torch.from_numpy(noise), tm.get_fs(tb),
                              deterministic=True)
        grads = torch.autograd.grad(loss, [named[n] for n in names])
    finally:
        for p in named.values():
            p.requires_grad_(True)
    assert any(masked_with_grad), "no key-masked cross-attention with a gradient reached _Flash"
    assert set(names) == set(jgrads) and {n.split(".")[0] for n in names} == {"adaptor", "image_proj", "zero_conv"}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    for name, g in zip(names, grads):
        ref = jgrads[name]
        assert float(np.abs(ref).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()), err_msg=name)


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
