"""The port's camera models against the JAX package, end to end.

`CamContextI2V.sample` at the oracle TINY dims (`refload.my_model`), made
plain (the flagship's epipolar band with the zero-translation perturbation,
no hybrid fallbacks): 2 context frames, 2 DDIM steps, CFG 7.5 with rescale
0.7, `uniform_trailing`, eta 0 and 1, decoded to pixels. Both sides get the
same seeded, non-zero weights (`seeded_params_for`), the same noise
from the JAX key chain, and the same perturbation draws (the JAX package's
`jax.random.normal(jax.random.key(0), ...)`, handed to the port as
`perturb_noise`). The CamI2V guided step on the fused batch-2B path is in
test_torch_camera_modules.py (it shares this file's helpers).

The JAX parameter tree is named and shaped after the port module (the
inverse of `utils.weights.load_jax_params`'s mapping): the strict load
checks it against the port and flax's shape checks against the JAX model,
and it costs nothing where `jax.eval_shape` of the model's init takes 6-8 s.

At TINY every epipolar level and the adaptor take the materialised-mask
path (hw < 256); the kernel paths are checked in
test_torch_camera_modules.py. Tolerance: 1e-4 of the output's max |value|
(f32 on both sides, summation order only).
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

from refload import make_batch, my_model  # noqa: E402
from test_torch_port_modules import assert_close, flat, jit_o0, one_torch_thread, port_config  # noqa: E402,F401

from camc2v_tpu_torch.nn.layers import Conv, Dense, GroupNorm32, LayerNormF32  # noqa: E402
from camc2v_tpu_torch.utils.weights import load_jax_params  # noqa: E402

STEPS = 2
SAMPLE_KW = dict(ddim_steps=STEPS, guidance_scale=7.5, guidance_rescale=0.7, timestep_spacing="uniform_trailing")


def plain_tiny(family):
    """The TINY JAX model of `family` with the flagship's plain epipolar
    config, CLIP text at 2 layers and the resampler fed by the vision tower."""
    jm = my_model(family)
    c = jm.config
    epi = dataclasses.replace(c.epipolar, epipolar_hybrid_attention=False, add_small_perturbation_on_zero_T=True)
    cfg = dataclasses.replace(
        c, epipolar=epi, unet=dataclasses.replace(c.unet, epipolar=epi),
        clip_text=dataclasses.replace(c.clip_text, layers=2),
        resampler=dataclasses.replace(c.resampler, embedding_dim=c.clip_vision.width),
    )
    return type(jm)(cfg, dtype=jnp.float32)


def seeded_params_for(tm, seed=0):
    """A seeded, fully non-zero JAX parameter tree for the port module `tm`:
    norm scales ~1, biases and gates small, everything else N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    modules = dict(tm.named_modules())
    tree = {}
    for name, p in tm.named_parameters():
        mod_name, leaf = name.rsplit(".", 1)
        m, path, shape = modules[mod_name], mod_name.split("."), tuple(p.shape)
        if isinstance(m, (GroupNorm32, LayerNormF32)):
            path.append("GroupNorm_0" if isinstance(m, GroupNorm32) else "LayerNorm_0")
            leaf = "scale" if leaf == "weight" else leaf
            v = 1.0 + 0.1 * rng.standard_normal(shape) if leaf == "scale" else 0.1 * rng.standard_normal(shape)
        elif isinstance(m, (Dense, Conv)) and leaf == "weight":
            leaf = "kernel"
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            v = v.T if v.ndim == 2 else v.transpose(*range(2, v.ndim), 1, 0)  # -> (in, out) / HWIO / DHWIO
        elif leaf in ("bias", "alpha"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(max(1, int(np.prod(shape[:-1]))))
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v, jnp.float32)
    load_jax_params(tm, flat(tree))
    return tree


def batches(n_ctx, b=2):
    nb = make_batch(b=b, n_ctx=n_ctx, seed=3)
    nb["caption_tokens"] = np.random.default_rng(4).integers(0, 62, (b, 77)).astype(np.int32)
    nb["frame_stride"] = np.array([3, 5][:b], np.int32)
    nb.pop("caption")
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}
    tb["caption_tokens"] = tb["caption_tokens"].long()
    return jb, tb


def perturb_draws(b, t):
    """The JAX camera_condition's perturbation draws (fixed key 0)."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.key(0), (b, t, t, 3, 1), jnp.float32)))


def jax_noise(key, shape):
    """x_T and the per-step eta noise of the JAX `sample(rng=key)` key chain."""
    pkey, skey = jax.random.split(key)
    x_t = torch.from_numpy(np.array(jax.random.normal(pkey, shape, jnp.float32)))
    noise = []
    for _ in range(STEPS):
        skey, nkey, _, _ = jax.random.split(skey, 4)
        noise.append(torch.from_numpy(np.array(jax.random.normal(nkey, shape, jnp.float32))))
    return x_t, noise


@pytest.fixture(scope="module")
def camcontext():
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V

    jm = plain_tiny("camcontext")
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    return jm, seeded_params_for(tm), tm


@pytest.fixture(scope="module")
def jax_sample(camcontext):
    """The JAX `sample`, jitted once with its DDIM tables as an input, so the
    eta-0 and eta-1 cases share one compiled program."""
    import camc2v_tpu.models.dynamicrafter as jdc

    jm = camcontext[0]

    def run(params, batch, key, ddim):
        class Given:
            @staticmethod
            def create(*_a, **_k):
                return ddim

        real, jdc.DDIMSchedule = jdc.DDIMSchedule, Given
        try:
            return jm.sample(params, batch, key, **SAMPLE_KW)
        finally:
            jdc.DDIMSchedule = real

    return jit_o0(run)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_camcontext_sample_matches_jax(camcontext, jax_sample, eta):
    from camc2v_tpu.core.schedules import DDIMSchedule

    jm, params, tm = camcontext
    jb, tb = batches(n_ctx=2)
    key = jax.random.key(11)
    ddim = DDIMSchedule.create(jm.schedule, STEPS, SAMPLE_KW["timestep_spacing"], eta)
    ref = np.asarray(jax_sample(params, jb, key, ddim))
    x_t, noise = jax_noise(key, (2, 4, 4, 4, 4))
    got = tm.sample(tb, x_T=x_t, step_noise=noise, ddim_eta=eta, perturb_noise=perturb_draws(2, 4),
                    **SAMPLE_KW).numpy()
    assert got.shape == ref.shape == (2, 4, 32, 32, 3)
    assert float(np.abs(ref).max()) > 0.1
    assert_close(got, ref)
