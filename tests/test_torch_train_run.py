"""The port's training run at TINY: padded context frames, checkpoints,
validation and the entry point.

  * padded contexts (n = 1, 2, 3 real frames padded to 4, `cond_frames_valid`):
    the port's `prepare_batch` c_concat and `p_losses` equal its unpadded
    ones within 2e-5 (TINY's adaptor takes the dense path, hw = 16 < 256);
  * the adaptor's kernel path at module level, hw = 256: `epipolar_flash_
    attention` with NaN lines for 2 padded frames, forward and gradients of
    its twin, against the same call on the unpadded keys and against the JAX
    `epipolar_flash` (Pallas, interpret mode) on the same NaN lines, within
    2e-5 of each output's max |value|; the padded keys' gradients exactly 0
    and their tiles off in the kernels' skip map;
  * the padded loss and trainable gradients against the JAX package's padded
    path: `test_torch_train_grads.py`;
  * checkpoints: save / restore bit-equal, mid accumulation window included;
    2 micro-steps + save + restore + 2 equal 4 straight within 1e-6 (f32);
  * validation: `Trainer.validate` equals the loss of `apply_model(...,
    deterministic=True)` (dropout off, a deliberate divergence from the JAX
    eval step), on the EMA weights when there are any;
  * the entry point `python -m camc2v_tpu_torch.main.train --device cpu` on
    the flagship yaml cut to TINY, 2 micro-steps, then `--continue` to 3.
"""

import copy
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, perturb_draws, plain_tiny, seeded_params_for  # noqa: E402
from test_torch_port_modules import port_config  # noqa: E402
from test_torch_train_data import write_tree  # noqa: E402
from test_torch_train_step import _dropout_model, one_torch_thread  # noqa: E402,F401

from camc2v_tpu_torch import presets  # noqa: E402
from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V  # noqa: E402
from camc2v_tpu_torch.parallel import trainer as TR  # noqa: E402
from camc2v_tpu_torch.utils import checkpoint as CK  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NMAX = 4


@pytest.fixture(scope="module")
def camcontext():
    jm = plain_tiny("camcontext")
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    return jm, seeded_params_for(tm), tm


def pad(batch: dict, nmax: int = NMAX) -> dict:
    """The collate's padding (zero frames, identity poses, validity) of a
    torch or numpy batch."""
    lib = torch if isinstance(batch["cond_frames"], torch.Tensor) else np
    cf, rt = batch["cond_frames"], batch["RT_cond"]
    b, n = cf.shape[:2]
    out = dict(batch)
    if lib is torch:
        out["cond_frames"] = torch.cat([cf, cf.new_zeros(b, nmax - n, *cf.shape[2:])], dim=1)
        out["RT_cond"] = torch.cat([rt, torch.eye(4).expand(b, nmax - n, 4, 4)], dim=1)
        out["cond_frames_valid"] = (torch.arange(nmax) < n).expand(b, nmax)
    else:
        out["cond_frames"] = jnp.concatenate([cf, jnp.zeros((b, nmax - n, *cf.shape[2:]), cf.dtype)], axis=1)
        out["RT_cond"] = jnp.concatenate([rt, jnp.broadcast_to(jnp.eye(4, dtype=rt.dtype), (b, nmax - n, 4, 4))], 1)
        out["cond_frames_valid"] = jnp.broadcast_to(jnp.arange(nmax) < n, (b, nmax))
    return out


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


# ----------------------------------------------------------- padded contexts

@pytest.mark.parametrize("n_ctx", [1, 2, 3])
def test_padded_contexts_match_unpadded(camcontext, n_ctx):
    _, _, tm = camcontext
    _, tb = batches(n_ctx=n_ctx)
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 4, 4, 4, 4)).astype(np.float32))
    t = torch.tensor([37, 911])
    out = {}
    with torch.no_grad():
        for name, batch in (("unpadded", tb), ("padded", pad(tb))):
            z, cond = tm.prepare_batch(batch, None, need_full_z=True, perturb_noise=perturb_draws(2, 4))
            loss, _ = tm.p_losses(z, cond, t, noise, tm.get_fs(batch), deterministic=True)
            out[name] = z, cond, loss
    (zu, cu, lu), (zp, cp, lp) = out["unpadded"], out["padded"]
    np.testing.assert_array_equal(zp.numpy(), zu.numpy())
    _close(cp["c_concat"], cu["c_concat"].numpy(), 2e-5, "c_concat")
    assert abs(lp.item() - lu.item()) <= 2e-5 * abs(lu.item())
    lu_tok = cu["c_crossattn"].shape[1]
    _close(cp["c_crossattn"][:, :lu_tok], cu["c_crossattn"].numpy(), 2e-5, "c_crossattn")
    mask = cp["c_crossattn_mask"]
    assert "c_crossattn_mask" not in cu and mask.shape == cp["c_crossattn"].shape[:2]
    assert mask[:, :lu_tok].all() and not mask[:, lu_tok:].any()


def _fundamental(t: int, img: int, seed: int = 4) -> np.ndarray:
    """(1, 1, t, 3, 3) f32 F from one query camera to t key cameras, each
    turned and moved apart (numpy: K^-T [t]x R K^-1)."""
    rng = np.random.default_rng(seed)
    K = np.array([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], np.float64)
    Ki = np.linalg.inv(K)
    out = np.zeros((1, 1, t, 3, 3), np.float32)
    for j in range(t):
        a = 0.05 * (j + 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        tv = np.array([0.3 * (j + 1), 0.1, -0.2 * j]) + 0.02 * rng.standard_normal(3)
        tx = np.array([[0, -tv[2], tv[1]], [tv[2], 0, -tv[0]], [-tv[1], tv[0], 0]])
        out[0, 0, j] = Ki.T @ tx @ R @ Ki
    return out


def test_padded_epipolar_kernel_path_matches_unpadded_and_jax():
    """The adaptor's in-kernel mask path at hw = 256 (16 x 16 latents at ds 8):
    256 queries over the cond frame and 4 context frames, the last 2 padded
    with NaN lines, 2 registers."""
    from camc2v_tpu.ops import epipolar_flash as jef

    from camc2v_tpu_torch.ops import epipolar_flash as tef

    t, kept, h, w, ds, r, heads = 5, 3, 16, 16, 8, 2, 1
    hw = h * w
    lines = tef.epipolar_lines(torch.from_numpy(_fundamental(t, h * ds)), h, w, ds).numpy()  # (1, 256, 5, 3)
    lines[:, :, kept:] = np.nan
    rng = np.random.default_rng(8)
    q, dout = (rng.standard_normal((1, hw, heads, 64)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, t * hw + r, heads, 64)).astype(np.float32) for _ in range(2))
    keep = np.r_[0:kept * hw, t * hw:t * hw + r]
    tl = torch.from_numpy(lines)
    tiles = tef.kernel_tile_map(tl, t, h, w, ds)
    assert not tiles[..., kept * hw // tef.KERNEL_BK:t * hw // tef.KERNEL_BK].any()

    def port(q_, k_, v_, lines_, tt, tile_any):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q_, k_, v_)]
        out = tef.epipolar_flash_attention(*xs, torch.from_numpy(lines_), t=tt, h=h, w=w, downsample=ds,
                                           num_registers=r, block_q=256, block_k=256, tile_any=tile_any)
        return out, torch.autograd.grad(out, xs, torch.from_numpy(dout))

    out, grads = port(q, k, v, lines, t, tiles)
    lines_u = np.ascontiguousarray(lines[:, :, :kept])
    out_u, grads_u = port(q, k[:, keep], v[:, keep], lines_u, kept,
                          tef.kernel_tile_map(torch.from_numpy(lines_u), kept, h, w, ds))
    pad_k = np.zeros((1, 256 - r, heads, 64), np.float32)  # the Pallas layout pads the registers to a key tile

    def jax_fn(q_, k_, v_):
        kp, vp = (jnp.concatenate([a, jnp.asarray(pad_k)], axis=1) for a in (k_, v_))
        return jef.epipolar_flash_attention(q_, kp, vp, jnp.asarray(lines), t=t, h=h, w=w, downsample=ds,
                                            num_registers=r, block_q=256, block_k=256)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(dout))
    _close(out, np.asarray(ref), 2e-5, "out vs JAX")
    _close(out, out_u.detach().numpy(), 2e-5, "out vs unpadded")
    for name, g, gr, gu in zip("qkv", grads, refs, grads_u):
        _close(g, np.asarray(gr), 2e-5, f"d{name} vs JAX")
        _close(g[:, keep] if name != "q" else g, gu.numpy(), 2e-5, f"d{name} vs unpadded")
        if name != "q":
            assert not g[:, kept * hw:t * hw].any(), f"d{name} of the padded keys"


# ------------------------------------------------------ checkpoints, validation

def _state_equal(a: TR.TrainState, b: TR.TrainState, tol: float = 0.0) -> None:
    sa, sb = CK.state_dict(a), CK.state_dict(b)
    assert (sa["step"], sa["updates"], sa["names"]) == (sb["step"], sb["updates"], sb["names"])
    pairs = [(sa["params"][n], sb["params"][n]) for n in sa["names"]]
    pairs += [(sa["acc_grads"][n], sb["acc_grads"][n]) for n in sa["names"]]
    for i, st in sa["optimizer"]["state"].items():
        pairs += [(st[k], sb["optimizer"]["state"][i][k]) for k in st]
    for x, y in pairs:
        if tol == 0.0:
            assert torch.equal(x, y)
        else:
            torch.testing.assert_close(x, y, rtol=tol, atol=tol * max(1e-6, float(y.abs().max())))


def test_checkpoint_resume_matches_straight(camcontext, tmp_path):
    """Accumulation 3 over 4 fixed padded batches (context counts 1, 2, 3, 2):
    4 straight micro-steps against 2 + save + restore into a fresh state + 2;
    the save at step 2 is mid accumulation window."""
    from camc2v_tpu_torch.main.harness import Trainer

    _, _, tm = camcontext
    cfg = dataclasses.replace(presets.camcontexti2v_256_train(), frozen_param_dtype=None, accumulate_grad_batches=3,
                              use_ema=True)
    data = [pad(batches(n_ctx=n, b=1)[1]) for n in (1, 2, 3, 2)]

    def fresh():
        m = copy.deepcopy(tm)
        return m, TR.init_train_state(cfg, m)

    m1, straight = fresh()
    Trainer(m1, cfg, data).fit(straight, max_steps=4)
    m2, first = fresh()
    Trainer(m2, cfg, data[:2], ckpt_dir=str(tmp_path), ckpt_every_n_steps=2).fit(first, max_steps=2)
    assert CK.saved_steps(str(tmp_path)) == [2] and any(a.abs().max() > 0 for a in first.acc_grads)
    m3, resumed = fresh()
    CK.restore_checkpoint(str(tmp_path), resumed)
    _state_equal(resumed, first)
    assert all(torch.equal(resumed.ema_params[n], first.ema_params[n]) for n in first.names)
    trainer = Trainer(m3, cfg, data[2:], ckpt_dir=str(tmp_path), ckpt_every_n_steps=2)
    trainer.fit(resumed, max_steps=4)
    assert trainer.resumed_from == 2 and resumed.updates == straight.updates == 1
    assert CK.saved_steps(str(tmp_path)) == [2, 4]
    _state_equal(resumed, straight, tol=1e-6)


def test_validate_matches_apply_model_deterministic():
    """`Trainer.validate` on a model with the flagship's dropout (0.1):
    equal to the loss of `apply_model(deterministic=True)` with batch i's
    draws from a generator seeded i, on the EMA weights, which it puts back."""
    from camc2v_tpu_torch.core.schedules import q_sample as tq_sample
    from camc2v_tpu_torch.main.harness import Trainer

    tm = _dropout_model()
    cfg = dataclasses.replace(presets.camcontexti2v_256_train(), frozen_param_dtype=None, use_ema=True)
    state = TR.init_train_state(cfg, tm)
    with torch.no_grad():
        for n in state.names:
            state.ema_params[n].mul_(0.9)
    batch = pad(batches(n_ctx=2)[1])
    masters = [p.detach().clone() for p in state.params]
    got = Trainer(tm, cfg, [], val_dataloader=[batch, batch], val_max_batches=1).validate(state)
    assert all(torch.equal(p, m) for p, m in zip(state.params, masters))
    with torch.no_grad():
        for n, p in zip(state.names, state.params):
            p.copy_(state.ema_params[n])
        g = torch.Generator().manual_seed(0)
        z, cond = tm.prepare_batch(batch, g, random_uncond=True, need_full_z=True)
        t = torch.randint(0, 1000, (2,), generator=g)
        noise = torch.randn(z.shape, generator=g)
        out = tm.apply_model(tq_sample(tm.schedule, z, t, noise), t, cond, tm.get_fs(batch), deterministic=True)
        want = tm.get_loss(out, noise).mean(dim=(1, 2, 3, 4)).mean().item()
    assert got == pytest.approx(want, rel=1e-6, abs=0)


# ------------------------------------------------------------- entry point

def tiny_yaml(path: Path, data: dict) -> str:
    """The flagship yaml cut to the oracle TINY model (4 frames of 32x32),
    its data path pointed at `data`."""
    import yaml

    from camc2v_tpu_torch.config_yaml import load_yaml

    cfg = load_yaml(str(REPO / "configs/models/camcontexti2v_256.yaml"))
    p = cfg["model"]["params"]
    p["unet_config"]["params"].update(model_channels=32, attention_resolutions=[2, 1], num_res_blocks=1,
                                      channel_mult=[1, 3], num_head_channels=8, context_dim=16, temporal_length=4)
    p["first_stage_config"]["params"]["ddconfig"].update(ch=32, num_res_blocks=1, resolution=32)
    p["image_proj_stage_config"]["params"].update(dim=32, depth=1, dim_head=8, heads=2, embedding_dim=16,
                                                  output_dim=16, video_length=4)
    p["pose_encoder_config"]["params"].update(channels=[32, 96], nums_rb=1, temporal_attention_nhead=2,
                                              temporal_position_encoding_max_len=4)
    p["multi_latent_adaptor"]["params"].update(query_dim=16, num_queries=16, video_length=4, depth=1)
    p["epipolar_config"].update(origin_h=32, origin_w=32, num_register_tokens=2, attention_resolution=[2, 1])
    p["clip_text_config"] = dict(vocab_size=49408, context_length=77, width=16, heads=2, layers=1)
    p["clip_vision_config"] = dict(image_size=224, patch_size=112, width=16, heads=2, layers=1)
    for split in ("train", "validation"):
        cfg["data"]["params"][split]["params"].update(video_length=4, resolution=[32, 32], **data)
    path.write_text(yaml.safe_dump(cfg, default_flow_style=None, width=4096))  # one-line flows: the port's subset
    return str(path)


def test_train_entry_point_end_to_end(tmp_path):
    from camc2v_tpu_torch.main import train

    config = tiny_yaml(tmp_path / "tiny.yaml", write_tree(tmp_path / "re10k", [f"v{i}" for i in range(4)]))
    argv = ["--config", config, "--device", "cpu", "--logdir", str(tmp_path / "runs"), "--name", "tiny",
            "data.params.num_workers=0", "data.params.validation_max_n_samples=2",
            "lightning.trainer.val_check_interval=2", "lightning.trainer.limit_val_batches=1",
            "lightning.trainer.log_every_n_steps=1", "lightning.logger=csv",
            "lightning.callbacks.metrics_over_trainsteps_checkpoint.params.every_n_train_steps=2",
            "lightning.callbacks.batch_logger.params.train_batch_frequency=2",
            "lightning.callbacks.batch_logger.params.log_images_kwargs.ddim_steps=2"]
    if not torch.cuda.is_available():  # the card by default: raises here without --device cpu
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.main([a for a in argv if a not in ("--device", "cpu")] + ["--max_steps", "1"])
    trainer, state = train.main(argv + ["--max_steps", "2"])
    run = tmp_path / "runs" / "tiny"
    assert state.step == 2 and [c["step"] for c in trainer.checkpoints] == [2] and trainer.val_history[0]["step"] == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history) and len(trainer.history) == 2
    assert len(list((run / "images").iterdir())) == 1  # the ImageLogger's samples at step 2
    trainer, state = train.main(argv + ["--max_steps", "3", "--continue"])
    assert trainer.resumed_from == 2 and state.step == 3 and [h["step"] for h in trainer.history] == [3]
    assert CK.saved_steps(str(run / "checkpoints")) == [2, 3]
    rows = (run / "logs" / "metrics.csv").read_text().splitlines()
    assert rows[0] == "step,grad_norm,loss,loss_simple" and [r.split(",")[0] for r in rows[1:]] == ["1", "2", "3"]
