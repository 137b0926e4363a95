"""The port's CamContextI2V training loss against the JAX package, at TINY.

  * the loss and the trainable gradients of one training-loss body (fixed
    timesteps, noise and conditioning; dropout off, the JAX
    `deterministic=True`) on the same seeded weights and numpy inputs: the
    JAX `prepare_batch(need_full_z=True)`, `q_sample`, `apply_model` and
    `get_loss` under `jax.value_and_grad` over the trainable subset, the
    port's `prepare_batch` and `p_losses` under `torch.autograd.grad`;
  * the trainable parameter set against the JAX `param_labels`.

At TINY every attention of the port takes `flash_attention`'s autograd
Function (the K2/K5 twins: `flash_fwd_plain`, `flash_bwd_plain`); the JAX
package differentiates its XLA attention. Tolerances: the f32 loss 1e-5
relative, each gradient 1e-4 of its max |value| (the same f32 algorithm in
another summation order).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, perturb_draws, plain_tiny, seeded_params_for  # noqa: E402
from test_torch_port_modules import flat, port_config  # noqa: E402
from test_torch_train_step import PATTERNS, _trainable, one_torch_thread  # noqa: E402,F401

from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V  # noqa: E402
from camc2v_tpu_torch.utils.weights import _to_torch_layout, jax_to_torch_name  # noqa: E402


@pytest.fixture(scope="module")
def camcontext():
    jm = plain_tiny("camcontext")
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    return jm, seeded_params_for(tm), tm


def test_trainable_set_matches_jax_param_labels(camcontext):
    from camc2v_tpu.parallel.trainer import param_labels

    _, params, tm = camcontext
    jlabels = flat(param_labels(params, PATTERNS))
    want = {jax_to_torch_name(k) for k, lab in jlabels.items() if lab == "train"}
    names, _ = _trainable(tm)
    assert set(names) == want
    assert {n.split(".")[0] for n in names} == {"adaptor", "image_proj", "zero_conv"}


def test_loss_and_trainable_gradients_match_jax(camcontext):
    from camc2v_tpu.core.schedules import q_sample

    jm, params, tm = camcontext
    jb, tb = batches(n_ctx=2)
    rng = np.random.default_rng(7)
    t = np.array([37, 911], np.int32)
    noise = rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32)

    def loss_fn(p):
        z, cond = jm.prepare_batch(p, jb, None, need_full_z=True)
        x_noisy = q_sample(jm.schedule, z, jnp.asarray(t), jnp.asarray(noise))
        out = jm.apply_model(p, x_noisy, jnp.asarray(t), cond, jm.get_fs(jb), deterministic=True)
        return jm.get_loss(out, jnp.asarray(noise)).mean(axis=(1, 2, 3, 4)).mean()

    from camc2v_tpu.parallel.trainer import param_labels

    # differentiate the trainable subset only, as the JAX train step does
    labels = param_labels(params, PATTERNS)
    split = lambda keep: jax.tree_util.tree_map(lambda lab, p: p if lab == keep else None, labels, params)  # noqa
    merge = lambda a, b: jax.tree_util.tree_map(lambda x, y: y if x is None else x, a, b,  # noqa: E731
                                                is_leaf=lambda x: x is None)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda tr, fr: loss_fn(merge(tr, fr))))(split("train"),
                                                                                       split("freeze"))
    jgrads = {jax_to_torch_name(k): _to_torch_layout(k, v) for k, v in flat(jgrads).items() if v.dtype != object}

    names, trainable = _trainable(tm)
    z, cond = tm.prepare_batch(tb, None, need_full_z=True, perturb_noise=perturb_draws(2, 4))
    assert z.shape == (2, 4, 4, 4, 4)
    loss, metrics = tm.p_losses(z, cond, torch.from_numpy(t).long(), torch.from_numpy(noise), tm.get_fs(tb),
                                deterministic=True)
    grads = torch.autograd.grad(loss, trainable)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["loss_simple"].item() == pytest.approx(loss.item())
    for name, g in zip(names, grads):
        ref = jgrads[name]
        assert float(np.abs(ref).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * float(np.abs(ref).max()), err_msg=name)
