"""Two costly camera-model checks against the JAX package, in a file of
three tests so that xdist (`--dist loadfile`, files queued by their number
of tests, most first) runs them beside `tests/test_tp.py` rather than before
it. Moved unchanged, names kept:

  * from `test_torch_sample_options.py`: `test_camera_cfg_sample_matches_jax`
    (a 3-step CamContextI2V `sample` with camera CFG, the paste and a
    conditioning frame other than 0; one JAX program, `jax_camera_sample`);
  * from `test_torch_camera_modules.py`: `test_cami2v_fused_guided_step_matches_jax`
    (one CamI2V guided denoise step on the fused batch-2B path).

Tolerance: 1e-4 of the output's max |value| (f32, summation order only).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import (  # noqa: E402,F401
    batches,
    camcontext,
    perturb_draws,
    plain_tiny,
    seeded_params_for,
)
from test_torch_port_modules import assert_close, jit_o0, one_torch_thread, port_config  # noqa: E402,F401
from test_torch_sample_options import T_, assert_rel, cleared_self_pair, jax_draws  # noqa: E402


@pytest.fixture(scope="module")
def jax_camera_sample(camcontext):
    """The JAX CamContextI2V `sample` of the 3-step camera-CFG recipe
    (cosine scheduler, the paste, fused CFG, latents returned with cond),
    compiled once with the DDIM tables, the conditioning frames and the
    translation scale as inputs; run at (frame 1, scale 1) and (frame 2,
    scale 0.5)."""
    import os

    import camc2v_tpu.models.dynamicrafter as jdc
    from camc2v_tpu.core.schedules import DDIMSchedule

    jm, params, _ = camcontext
    ddim = DDIMSchedule.create(jm.schedule, 3, "uniform_trailing", 1.0)

    def run(params, batch, key, ddim, cfi, tsf):
        class Given:
            @staticmethod
            def create(*_a, **_k):
                return ddim

        real, jdc.DDIMSchedule = jdc.DDIMSchedule, Given
        try:
            out, cond = jm.sample(params, batch, key, cond_frame_index=cfi, trace_scale_factor=tsf, **CAMERA_KW)
        finally:
            jdc.DDIMSchedule = real
        cam = cond["camera"]
        return out, cond["c_concat"], cond["origin_z0"], cond["c_crossattn"], cam["F"], cam["plucker"]

    jb, _ = batches(n_ctx=2)
    saved = os.environ.get("CAMC2V_FUSED_CFG")
    os.environ["CAMC2V_FUSED_CFG"] = "1"
    try:
        fn = jit_o0(run)
        with cleared_self_pair():
            return {cfi: [np.asarray(a) for a in jax.tree_util.tree_leaves(
                fn(params, jb, jax.random.key(12), ddim, jnp.full((2,), cfi, jnp.int32), jnp.float32(tsf)))]
                for cfi, tsf in ((1, 1.0), (2, 0.5))}
    finally:
        if saved is None:
            os.environ.pop("CAMC2V_FUSED_CFG")
        else:
            os.environ["CAMC2V_FUSED_CFG"] = saved



CAMERA_KW = dict(ddim_steps=3, guidance_scale=7.5, guidance_rescale=0.7, timestep_spacing="uniform_trailing",
                 camera_cfg=1.5, camera_cfg_scheduler="cosine", paste_cond_frame=True, decode=False, return_cond=True)



@pytest.mark.parametrize("cfi,tsf", [(1, 1.0), (2, 0.5)])
def test_camera_cfg_sample_matches_jax(camcontext, jax_camera_sample, monkeypatch, cfi, tsf):
    """CamContextI2V `sample` end to end through its UNet: 3 DDIM steps, CFG
    7.5 with rescale 0.7 and camera CFG 1.5 (cosine), fused CFG on (so the
    camera-free pass runs on the padded cond), the conditioning frame pasted
    (every frame VAE-encoded), at conditioning frame 1 and at frame 2 with
    the translations scaled by 0.5: the latents, and `prepare_batch`'s
    c_concat, origin_z0, context and camera payload (F, the Plücker
    pyramid). The pasted frame equals origin_z0 bit for bit. The adaptor's
    degenerate self-pair block is cleared on both sides
    (`cleared_self_pair`)."""
    _, _, tm = camcontext
    monkeypatch.setenv("CAMC2V_FUSED_CFG", "1")
    _, tb = batches(n_ctx=2)
    key = jax.random.key(12)
    pkey, skey = jax.random.split(key)
    x_t = T_(jax.random.normal(pkey, (2, 4, 4, 4, 4), jnp.float32))
    draws = jax_draws(skey, 3, ("noise", None, None), dict(noise=(2, 4, 4, 4, 4)))
    with cleared_self_pair():
        out, cond = tm.sample(tb, x_T=x_t, step_noise=draws, perturb_noise=perturb_draws(2, 4),
                              cond_frame_index=torch.full((2,), cfi), trace_scale_factor=tsf, **CAMERA_KW)
    cam = cond["camera"]
    got = [out, cond["c_concat"], cond["origin_z0"], cond["c_crossattn"], cam["F"], *cam["plucker"]]
    ref = jax_camera_sample[cfi]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert_rel(g.numpy(), r, 1e-4)
    assert torch.equal(out[:, cfi], cond["origin_z0"][:, cfi])
    assert torch.equal(cond["c_cond_frame_index"], torch.full((2,), cfi))


def test_cami2v_fused_guided_step_matches_jax():
    """CamI2V's cond and uncond contexts have one shape, so the guided step
    runs as one batch-2B UNet call with the camera payload (Plücker pyramid,
    F, per-level lines and tile maps) stacked with the batch. The JAX side
    builds its own payload from the same poses."""
    from camc2v_tpu_torch.models.camera_base import CamI2V

    jm = plain_tiny("cami2v")
    tm = CamI2V(port_config(jm.config), dtype=torch.float32)
    params = seeded_params_for(tm, seed=1)
    jb, tb = batches(n_ctx=0)
    rng = np.random.default_rng(6)
    x, c_concat = (rng.standard_normal((2, 4, 4, 4, 4)).astype(np.float32) for _ in range(2))
    ctx, uctx = (rng.standard_normal((2, 77 + 64, 16)).astype(np.float32) for _ in range(2))
    t, idx = np.array([999, 999], np.int32), np.zeros(2, np.int32)
    kw = dict(guidance_scale=7.5, guidance_rescale=0.7)

    def jax_step(p, batch, x, c_concat, ctx, uctx, t, idx):
        cond = {"c_concat": c_concat, "c_crossattn": ctx, "camera": jm.camera_condition(p, batch, idx, 1.0)}
        return jm.build_guided_fn(p, cond, dict(cond, c_crossattn=uctx), jm.get_fs(batch), **kw)(x, t)

    ref = np.asarray(jit_o0(jax_step)(params, jb, *(jnp.asarray(a) for a in (x, c_concat, ctx, uctx, t, idx))))
    with torch.no_grad():
        camera = tm.camera_condition(tb, torch.from_numpy(idx).long(), perturb_noise=perturb_draws(2, 4))
        assert set(camera["epi_prep"]) == {8, 16} and len(camera["plucker"]) == 2
        cond = {"c_concat": torch.from_numpy(c_concat), "c_crossattn": torch.from_numpy(ctx), "camera": camera}
        calls = []
        real = tm.apply_model
        tm.apply_model = lambda x_, t_, c_, fs_: calls.append(x_.shape[0]) or real(x_, t_, c_, fs_)
        try:
            fn = tm.build_guided_fn(cond, dict(cond, c_crossattn=torch.from_numpy(uctx)), tm.get_fs(tb), **kw)
            got = fn(torch.from_numpy(x), torch.from_numpy(t), 999)
        finally:
            del tm.apply_model
    assert calls == [4]  # one batch-2B call
    assert_close(got.numpy(), ref)
