"""The port's training machinery against the JAX package, and its training
path at TINY (the loss and gradients against JAX are in
test_torch_train_loss.py).

  * the optimizer chain (AdamW, global-norm clip, accumulation) over three
    optimizer steps of accumulation 2 fed the same gradients, against the
    JAX `make_optimizer` optax chain, for the three learning-rate schedules;
  * `update_ema` against the JAX EMA;
  * the flagship training preset against `build_train_config` of
    configs/models/camcontexti2v_256.yaml, field by field.

Port-only checks: remat on and off give the same gradients with dropout on;
dropout is active only with `deterministic=False`; the gradient reaches the
zero conv, the Resampler and the adaptor through every kernel seam (K1-K4,
K6, with their autograd Functions) when the seams take their kernel routes
(twins inside, on the CPU); `Trainer.fit` with a flag schedule; and the
overfit-one-batch learning test.

Tolerances: optimizer and EMA 1e-6 relative (float rounding of the same
update formula in another order); remat on against off 1e-6 relative (the
same arithmetic recomputed).
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

from refload import Dims, my_model  # noqa: E402
from test_torch_camera_generate import batches, plain_tiny  # noqa: E402
from test_torch_port_modules import one_torch_thread, port_config  # noqa: E402,F401

from camc2v_tpu_torch import ops, presets  # noqa: E402
from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V  # noqa: E402
from camc2v_tpu_torch.parallel import trainer as TR  # noqa: E402
from camc2v_tpu_torch.utils.weights import init_weights  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PATTERNS = presets.camcontexti2v_256_train().trainable_patterns


def _trainable(tm):
    """Freeze all but the flagship's trainable subset; (names, params)."""
    labels = TR.param_labels(tm, PATTERNS)
    named = dict(tm.named_parameters())
    for name, p in named.items():
        p.requires_grad_(labels[name] == "train")
    names = [n for n, lab in labels.items() if lab == "train"]
    return names, [named[n] for n in names]


SCHEDULES = [None, ("lambda_warmup", 2), ("cosine", 3, 1e-4)]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=["constant", "warmup", "cosine"])
def test_optimizer_chain_matches_optax(schedule):
    """Three optimizer steps of accumulation 2 (six micro-steps) fed the same
    gradients: AdamW over the trainable subset, clip of the accumulated mean
    (some windows over the 0.5 bound, some under), frozen weights untouched."""
    import optax

    from camc2v_tpu.parallel.trainer import TrainConfig as JTrainConfig
    from camc2v_tpu.parallel.trainer import make_optimizer

    kw = dict(learning_rate=1e-2, weight_decay=1e-2, grad_clip=0.5, accumulate_grad_batches=2,
              trainable_patterns=(r"^adaptor/",), lr_schedule=schedule)
    model = torch.nn.ModuleDict({"adaptor": torch.nn.Linear(5, 3), "unet": torch.nn.Linear(3, 2)})
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
    jparams = {m: {leaf: jnp.asarray(getattr(model[m], leaf).detach().numpy()) for leaf in ("weight", "bias")}
               for m in ("adaptor", "unet")}
    frozen = model["unet"].weight.detach().clone()
    state = TR.init_train_state(TR.TrainConfig(**kw), model)
    assert state.names == ["adaptor.weight", "adaptor.bias"]
    tx = make_optimizer(JTrainConfig(**kw), jparams)
    opt_state = tx.init(jparams)
    sched = TR.make_lr_schedule(TR.TrainConfig(**kw))
    for step, scale in enumerate([0.05, 0.1, 1.0, 0.8, 0.02, 0.03]):
        g = {m: {leaf: (scale * rng.standard_normal(jparams[m][leaf].shape)).astype(np.float32)
                 for leaf in ("weight", "bias")} for m in ("adaptor", "unet")}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        TR.apply_gradients(state, TR.TrainConfig(**kw), [torch.from_numpy(g["adaptor"][leaf])
                                                         for leaf in ("weight", "bias")], sched)
    assert state.step == 6 and state.updates == 3
    for leaf in ("weight", "bias"):
        np.testing.assert_allclose(getattr(model["adaptor"], leaf).detach().numpy(), jparams["adaptor"][leaf],
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(model["unet"].weight, frozen) and not model["unet"].weight.requires_grad
    np.testing.assert_array_equal(model["unet"].weight.detach().numpy(), jparams["unet"]["weight"])


def test_ema_matches_jax():
    from camc2v_tpu.core import ema as jema

    from camc2v_tpu_torch.core import ema as tema

    rng = np.random.default_rng(1)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    te, je = tema.init_ema(tp), jema.init_ema(params)
    for step in range(4):
        new = {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        je = jema.update_ema(je, new, jnp.asarray(step), 0.99)
        tema.update_ema(te, {k: torch.from_numpy(v) for k, v in new.items()}, step, 0.99)
    for k in params:
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]), rtol=1e-6)


def test_train_preset_matches_the_flagship_yaml():
    from camc2v_tpu.config_yaml import build_train_config, load_yaml

    j = build_train_config(load_yaml(str(REPO / "configs/models/camcontexti2v_256.yaml")))
    t = presets.camcontexti2v_256_train()
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert jf - tf == {"shard_params"} and not j.shard_params  # one device: no mesh
    for name in tf:
        jv = getattr(j, name)
        if isinstance(getattr(t, name), float):  # YAML reads `1e-4` (no dot) as a string
            jv = float(jv)
        assert getattr(t, name) == jv, name
    with pytest.raises(NotImplementedError, match="scale_lr"):  # the world-batch scale needs the mesh
        TR.make_lr_schedule(dataclasses.replace(t, scale_lr=True))


# ------------------------------------------------------------ port only

def _dropout_model(seed=0):
    """TINY CamContextI2V with the flagship's ResBlock dropout (0.1)."""
    jcfg = plain_tiny("camcontext").config
    cfg = port_config(jcfg)
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(cfg.unet, dropout=0.1))
    tm = CamContextI2V(cfg, dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(seed))
    return tm


def _one_step(tm, tb, seed, deterministic=False):
    """Loss and trainable gradients of one body with fixed t and noise; the
    dropout draws from the global RNG seeded with `seed`."""
    names, trainable = _trainable(tm)
    torch.manual_seed(seed)
    z, cond = tm.prepare_batch(tb, None, need_full_z=True)
    t = torch.tensor([500, 20])
    noise = torch.from_numpy(np.random.default_rng(3).standard_normal(z.shape).astype(np.float32))
    loss, _ = tm.p_losses(z, cond, t, noise, tm.get_fs(tb), deterministic=deterministic)
    return loss.detach(), torch.autograd.grad(loss, trainable)


def test_remat_keeps_gradients_with_dropout_on(monkeypatch):
    from camc2v_tpu_torch.nn import unet3d

    tm = _dropout_model()
    _, tb = batches(n_ctx=2)
    calls = []
    real = unet3d.checkpoint
    monkeypatch.setattr(unet3d, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    loss_r, grads_r = _one_step(tm, tb, seed=5)
    assert calls, "remat did not checkpoint any layer"
    tm.unet.config = dataclasses.replace(tm.unet.config, remat=False)
    n = len(calls)
    loss, grads = _one_step(tm, tb, seed=5)
    assert len(calls) == n
    assert torch.equal(loss, loss_r)
    for g, gr in zip(grads, grads_r):
        torch.testing.assert_close(g, gr, rtol=1e-6, atol=1e-7)
    # dropout is on in training: another seed draws other masks
    assert not torch.equal(_one_step(tm, tb, seed=6)[0], loss)


def test_dropout_only_in_training():
    tm = _dropout_model()
    _, tb = batches(n_ctx=2)
    with torch.no_grad():
        z, cond = tm.prepare_batch(tb, None, need_full_z=True)
        x = torch.randn(z.shape, generator=torch.Generator().manual_seed(0))
        t = torch.tensor([500, 20])
        outs = {}
        for det in (True, False):
            for seed in (1, 2):
                torch.manual_seed(seed)
                outs[det, seed] = tm.apply_model(x, t, cond, tm.get_fs(tb), deterministic=det)
    assert torch.equal(outs[True, 1], outs[True, 2])
    assert not torch.equal(outs[False, 1], outs[False, 2])
    assert not torch.equal(outs[False, 1], outs[True, 1])


def test_gradient_reaches_trainables_through_every_seam(monkeypatch):
    """With every seam on its kernel route (`ops.route` forced true; on CPU
    tensors the Functions run their twins), one training step at 128x128
    with 16x16 latents, where the UNet's ds8 epipolar level and the adaptor
    take K6's layout: each seam's autograd Function runs its backward, and
    the zero conv, the Resampler and the adaptor get non-zero gradients."""
    from camc2v_tpu_torch.ops import epipolar_flash as ef
    from camc2v_tpu_torch.ops import flash_attention as fa

    dims = Dims(T=4, IMG=128, LAT=16, CTX_DIM=16, MODEL_CH=32, channel_mult=[1, 3], attention_resolutions=[2, 1],
                num_res_blocks=1, epipolar_resolution=[2, 1], n_reg=2, pose_channels=[32, 96], nums_rb=1,
                plain_epipolar=True)
    jcfg = my_model("camcontext", dims=dims).config
    cfg = port_config(dataclasses.replace(jcfg, clip_text=dataclasses.replace(jcfg.clip_text, layers=1),
                                          resampler=dataclasses.replace(jcfg.resampler,
                                                                        embedding_dim=jcfg.clip_vision.width)))
    tm = CamContextI2V(cfg, dtype=torch.float32)
    init_weights(tm, torch.Generator().manual_seed(0))
    names, trainable = _trainable(tm)

    seen = []
    for fn_cls in (ops._Recompute, fa._Flash, ef._Epipolar):
        real = fn_cls.backward

        def backward(ctx, *g, _real=real, _cls=fn_cls):
            twin = getattr(ctx, "twin", None)
            seen.append(twin.func.__name__ if twin is not None else _cls.__name__)
            return _real(ctx, *g)

        monkeypatch.setattr(fn_cls, "backward", staticmethod(backward))
    monkeypatch.setattr(ops, "route", lambda x, dtype=None, takes=None: True)

    rng = np.random.default_rng(0)
    tb = {
        "video": torch.from_numpy(rng.uniform(-1, 1, (1, 4, 128, 128, 3)).astype(np.float32)),
        "cond_frames": torch.from_numpy(rng.uniform(-1, 1, (1, 2, 128, 128, 3)).astype(np.float32)),
        "caption_tokens": torch.from_numpy(rng.integers(0, 62, (1, 77))),
        "frame_stride": torch.tensor([3]),
    }
    nb = batches(n_ctx=2, b=1)[1]
    K = torch.tensor([[128.0, 0, 64], [0, 128.0, 64], [0, 0, 1]])
    tb.update(camera_intrinsics=K.expand(1, 4, 3, 3), RT=nb["RT"], RT_cond=nb["RT_cond"])
    loss, _ = tm.training_loss(tb, torch.Generator().manual_seed(1))
    grads = dict(zip(names, torch.autograd.grad(loss, trainable)))
    assert set(seen) >= {"group_norm_plain", "mha_plain", "ff_plain", "_Flash", "_Epipolar"}, set(seen)
    assert seen.count("_Epipolar") >= 2  # the UNet's ds8 level and the adaptor
    for prefix in ("zero_conv.", "image_proj.", "adaptor."):
        assert any(n.startswith(prefix) and g.abs().max() > 0 for n, g in grads.items()), prefix


def test_trainer_fit_runs_phases_and_updates_only_trainables(monkeypatch):
    from camc2v_tpu_torch.main.harness import Trainer

    tm = _dropout_model()
    _, tb = batches(n_ctx=2, b=1)
    cfg = dataclasses.replace(presets.camcontexti2v_256_train(), frozen_param_dtype=None, accumulate_grad_batches=2)
    state = TR.init_train_state(cfg, tm)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    flags = []
    real = tm.training_loss
    monkeypatch.setattr(tm, "training_loss", lambda batch, gen, **kw: flags.append(kw) or real(batch, gen, **kw))
    trainer = Trainer(tm, cfg, [tb], flag_schedule=[(0, {"adaptor_use_mask": False}), (2, {})],
                      log_every_n_steps=2)
    state = trainer.fit(state, max_steps=4)
    assert state.step == 4 and state.updates == 2
    assert flags == [{"adaptor_use_mask": False}] * 2 + [{}] * 2
    assert [h["step"] for h in trainer.history] == [2, 4]
    assert all(np.isfinite(h[k]) for h in trainer.history for k in ("loss", "loss_simple", "grad_norm"))
    params = dict(tm.named_parameters())
    for n, p in params.items():
        assert n in state.names or torch.equal(p, before[n]), n
    assert sum(not torch.equal(params[n], before[n]) for n in state.names) > len(state.names) // 2
    with pytest.raises(NotImplementedError, match="mesh"):  # checkpoints, callbacks and validation are ported
        Trainer(tm, cfg, [tb], mesh=object())


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
