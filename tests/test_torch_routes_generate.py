"""CamContextI2V generation on the opt-in routes, the port against the JAX
package.

`CamContextI2V.sample` at the oracle TINY dims (the plain-epipolar TINY
model of test_torch_camera_generate.py: 2 context frames, CFG 7.5 with
rescale 0.7, `uniform_trailing`), with `CAMC2V_EPI_PRECOMP=1` and
`CAMC2V_FUSED_CFG=1` on both sides and `sampler="dpmpp_2m"` over 3 steps (so
the middle step is second order), decoded to pixels, on the same seeded
weights, x_T from the JAX key chain and the same perturbation draws. The norm
switches (K8, K9) act only on the card in both packages, and at TINY every
epipolar level is under the kernel's tiling (hw < 256), so the penalties
themselves are checked in test_torch_routes_ops.py; here the fused-CFG path
(the uncond padded to the context's length with a per-frame key mask, one
batch-2B UNet call per step) and the DPM++(2M) loop are what is held to JAX.
Also the counterparts of tests/test_camera_models.py's fused-CFG tests:
fused equals unfused, and precomputed penalties are shared by the stacked
batch, not duplicated. The weights pass through
`tests/util.py::perturb_zero_kernels` and every zero-initialised branch
(zero conv, epipolar out-projection) is checked non-zero, so the camera,
context and CFG branches are not vacuous.

Tolerance: 1e-4 of the output's max |value| (f32 on both sides, summation
order only); fused against unfused in the port 3e-5, as in the JAX test.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_generate import batches, jax_noise, perturb_draws, plain_tiny, seeded_params_for  # noqa: E402
from test_torch_port_modules import assert_close, flat, jit_o0, one_torch_thread, port_config  # noqa: E402,F401
from util import perturb_zero_kernels  # noqa: E402

from camc2v_tpu_torch.nn.epipolar import Epipolar  # noqa: E402
from camc2v_tpu_torch.utils.weights import load_jax_params  # noqa: E402

STEPS = 3
SAMPLE_KW = dict(ddim_steps=STEPS, sampler="dpmpp_2m", guidance_scale=7.5, guidance_rescale=0.7,
                 timestep_spacing="uniform_trailing")
ROUTES = {"CAMC2V_EPI_PRECOMP": "1", "CAMC2V_FUSED_CFG": "1"}


@pytest.fixture(scope="module")
def camcontext():
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V

    jm = plain_tiny("camcontext")
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    params = perturb_zero_kernels(seeded_params_for(tm))
    load_jax_params(tm, flat(params))
    epipolar = [m for m in tm.modules() if isinstance(m, Epipolar)]
    assert epipolar
    for zero_init in [tm.zero_conv.weight] + [m.epipolar_attn.to_out.weight for m in epipolar]:
        assert float(zero_init.detach().abs().min()) > 0
    return jm, params, tm


@pytest.fixture
def routes_on(monkeypatch):
    for k, v in ROUTES.items():
        monkeypatch.setenv(k, v)


def _count_unet_calls(monkeypatch, model):
    calls = []
    real = model.apply_model

    def record(x, t, cond, fs=None, **kw):
        calls.append((x.shape[0], cond.get("c_crossattn_mask")))
        return real(x, t, cond, fs, **kw)

    monkeypatch.setattr(model, "apply_model", record)
    return calls


def test_sample_on_the_routes_matches_jax(camcontext, routes_on, monkeypatch):
    import camc2v_tpu.models.dynamicrafter as jdc
    from camc2v_tpu.core.schedules import DDIMSchedule

    jm, params, tm = camcontext
    jb, tb = batches(n_ctx=2)
    key = jax.random.key(13)
    ddim = DDIMSchedule.create(jm.schedule, STEPS, SAMPLE_KW["timestep_spacing"], 1.0)

    class Given:
        @staticmethod
        def create(*_a, **_k):
            return ddim

    monkeypatch.setattr(jdc, "DDIMSchedule", Given)
    ref = np.asarray(jit_o0(lambda p, b, k: jm.sample(p, b, k, **SAMPLE_KW))(params, jb, key))
    x_t, _ = jax_noise(key, (2, 4, 4, 4, 4))
    calls = _count_unet_calls(monkeypatch, tm)
    got = tm.sample(tb, x_T=x_t, perturb_noise=perturb_draws(2, 4), **SAMPLE_KW).numpy()
    # one fused batch-2B call per step, the padded uncond's (2B, T, L) key mask with it
    assert [n for n, _ in calls] == [4] * STEPS and all(m is not None and m.shape[:2] == (4, 4) for _, m in calls)
    assert got.shape == ref.shape == (2, 4, 32, 32, 3)
    assert float(np.abs(ref).max()) > 0.1
    assert_close(got, ref)


def test_fused_cfg_equals_unfused(camcontext, monkeypatch):
    """CAMC2V_FUSED_CFG=1 (uncond padded, per-frame routing as a (B, T, L)
    mask, one batch-2B call) equals the unfused two-call CFG (the counterpart
    of tests/test_camera_models.py::test_fused_cfg_padding_exact)."""
    _, _, tm = camcontext
    _, tb = batches(n_ctx=2, b=1)
    with torch.no_grad():
        z, cond = tm.prepare_batch(tb, perturb_noise=perturb_draws(1, 4))
        uc = tm.build_uncond(cond, 1, (32, 32))
        assert uc["c_crossattn"].shape != cond["c_crossattn"].shape  # not fusable without the padding
        assert tm._pad_uncond_for_fusion(dict(cond), dict(uc)) is not None
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(tuple(z.shape)).astype(np.float32))
        t = torch.full((1,), 500, dtype=torch.int32)
        fs = tm.get_fs(tb)
        monkeypatch.delenv("CAMC2V_FUSED_CFG", raising=False)
        calls = _count_unet_calls(monkeypatch, tm)
        unfused = tm.build_guided_fn(dict(cond), dict(uc), fs, guidance_scale=7.5)(x, t, 500)
        monkeypatch.setenv("CAMC2V_FUSED_CFG", "1")
        fused = tm.build_guided_fn(dict(cond), dict(uc), fs, guidance_scale=7.5)(x, t, 500)
    assert [n for n, _ in calls] == [1, 1, 2]
    assert float(unfused.abs().max()) > 0.1
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=0, atol=3e-5 * float(unfused.abs().max()))


def test_fused_cfg_keeps_batch_shared_penalties(camcontext, monkeypatch):
    """The fused batch shares cond's precomputed penalties instead of
    stacking them (K6p reads them modulo their batch); everything else is
    stacked (the counterpart of tests/test_camera_models.py::
    test_fused_cfg_keeps_batch_shared_penalties)."""
    _, _, tm = camcontext
    monkeypatch.setenv("CAMC2V_FUSED_CFG", "1")
    _, tb = batches(n_ctx=2, b=1)
    with torch.no_grad():
        z, cond = tm.prepare_batch(tb, perturb_noise=perturb_draws(1, 4))
    pen = torch.zeros(1, 32, 64, dtype=torch.bfloat16)
    cond["camera"]["epi_prep"] = {8: {"penalties": pen, "tile_any": torch.ones(1, 1, 1, dtype=torch.int32),
                                      "lines": torch.zeros(1, 32, 4, 3)}}
    uc = tm.build_uncond(cond, 1, (32, 32))
    seen = {}

    def record(x, t, c, fs=None, **kw):
        seen["cond"] = c
        return torch.zeros_like(x[..., :4])

    monkeypatch.setattr(tm, "apply_model", record)
    tm.build_guided_fn(cond, uc, None, guidance_scale=7.5)(torch.zeros(1, 4, 4, 4, 4), torch.zeros(1), 0)
    stacked = seen["cond"]
    prep = stacked["camera"]["epi_prep"][8]
    assert prep["penalties"] is pen  # shared, not duplicated
    assert prep["lines"].shape[0] == 2 and prep["tile_any"].shape[0] == 2  # everything else fused
    assert stacked["c_concat"].shape[0] == 2 and stacked["c_crossattn_mask"].shape[0] == 2
    assert "penalties" in cond["camera"]["epi_prep"][8]  # the caller's cond is left as it was
