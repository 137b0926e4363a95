"""Three costly checks of the port's UNet and its training, in a file of
three tests so that xdist (`--dist loadfile`, files queued by their number
of tests, most first) runs them beside `tests/test_tp.py` rather than before
it. Moved unchanged, names kept:

  * from `test_torch_port_modules.py`: `test_unet_matches_jax` (the UNet at
    the oracle TINY dims against the JAX UNet, 1e-4 of the output's max
    |value|);
  * from `test_torch_train_ops.py`: `test_geglu_ff_seam_gradient_matches_jax`
    (K4's seam gradient against `jax.grad` of the JAX seam, within 4 bf16
    ulps);
  * from `test_torch_train_step.py`: `test_overfit_one_batch` (the trainer's
    optimizer on one fixed batch: the loss falls 10x within 20 steps).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import TINY, my_model  # noqa: E402
from test_torch_camera_generate import batches  # noqa: E402
from test_torch_port_modules import _normal, assert_close, jax_params, port_config, run_both  # noqa: E402
from test_torch_train_ops import ULP, _close, _jax_vjp, _made_by, _port_vjp  # noqa: E402
from test_torch_train_step import PATTERNS, _dropout_model, one_torch_thread  # noqa: E402,F401

from camc2v_tpu.ops import geglu_ff as jff  # noqa: E402

from camc2v_tpu_torch import config as pc  # noqa: E402
from camc2v_tpu_torch.ops import geglu_ff as tff  # noqa: E402
from camc2v_tpu_torch.parallel import trainer as TR  # noqa: E402


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


def test_overfit_one_batch():
    """The trainer's optimizer on one fixed batch (fixed conditioning,
    timesteps and noise), dropout on, the flagship's trainable subset plus
    the UNet: the loss falls by at least 10x within 20 steps."""
    tm = _dropout_model(seed=4)
    _, tb = batches(n_ctx=2, b=1)
    cfg = TR.TrainConfig(learning_rate=2e-3, weight_decay=0.0, grad_clip=1.0,
                         trainable_patterns=PATTERNS + (r"^unet/",))
    state = TR.init_train_state(cfg, tm)
    sched = TR.make_lr_schedule(cfg)
    t = torch.tensor([400])
    losses = []
    for step in range(20):
        torch.manual_seed(step)
        z, cond = tm.prepare_batch(tb, None, need_full_z=True)
        noise = torch.from_numpy(np.random.default_rng(0).standard_normal(z.shape).astype(np.float32))
        loss, _ = tm.p_losses(z, cond, t, noise, tm.get_fs(tb))
        TR.apply_gradients(state, cfg, torch.autograd.grad(loss, state.params), sched)
        losses.append(loss.item())
    assert losses[-1] < losses[0] / 10, losses[::5]
