"""The PyTorch port's generation path against the JAX package, end to end.

`DynamiCrafter.sample` at the oracle TINY dims (`refload.my_model`), 3 DDIM
steps, CFG 7.5 with rescale 0.7, `uniform_trailing` spacing, eta 0 and 1,
decoded to pixels. Both sides get the same seeded weights (see
`test_torch_port_modules.py`) and the same noise: x_T and every step's eta
noise are drawn from the JAX key chain of `DynamiCrafter.sample` /
`ddim_sample` and handed to the port.

The UNet at MID (the flagship's four-level ds routing) is checked here too.
These are the port's three costliest checks (each compiles a large JAX
program); keeping them in a file of three tests lets pytest-xdist's
loadscope order (files with the most tests first) start them after the
suite's long files instead of ahead of them.

Tolerance: 1e-4 of the output's max |value|. Everything runs in f32; the two
sides differ by summation order only (observed ~5e-6 relative).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import MID, my_model  # noqa: E402
from test_torch_port_modules import (  # noqa: E402
    _normal,
    assert_close,
    flat,
    jax_params,
    port_config,
    run_both,
    seeded_tree,
    tiny_generation_config,
)

from camc2v_tpu_torch import config as pc  # noqa: E402

from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter  # noqa: E402
from camc2v_tpu_torch.utils.weights import load_jax_params  # noqa: E402

STEPS = 3
SAMPLE_KW = dict(ddim_steps=STEPS, guidance_scale=7.5, guidance_rescale=0.7, timestep_spacing="uniform_trailing")


@pytest.fixture(scope="module")
def models():
    """JAX TINY DynamiCrafter with its params, and the port loaded from them."""
    cfg = tiny_generation_config()
    jm = type(my_model("dynamicrafter"))(cfg, dtype=jnp.float32)
    params = seeded_tree(jax.eval_shape(lambda k: jm.init_params(k, image_hw=(32, 32)), jax.random.key(0)))
    tm = DynamiCrafter(port_config(cfg), dtype=torch.float32)
    load_jax_params(tm, flat(params))
    return jm, params, tm


def _batch(seed=5, b=2):
    rng = np.random.default_rng(seed)
    return dict(
        video=rng.uniform(-1, 1, (b, 4, 32, 32, 3)).astype(np.float32),
        caption_tokens=rng.integers(0, 62, (b, 77)).astype(np.int32),  # 62, 63 are <sot>, <eot>
        frame_stride=np.array([3, 5][:b], np.int32),
    )


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["caption_tokens"] = out["caption_tokens"].long()
    return out


def _jax_noise(key, shape):
    """x_T and the per-step eta noise of `DynamiCrafter.sample(rng=key)`:
    `pkey, skey = split(key)`; x_T ~ N(pkey); each DDIM step splits its
    carried key four ways and draws the eta noise from the second."""
    pkey, skey = jax.random.split(key)
    x_t = torch.from_numpy(np.array(jax.random.normal(pkey, shape, jnp.float32)))
    noise = []
    for _ in range(STEPS):
        skey, nkey, _, _ = jax.random.split(skey, 4)
        noise.append(torch.from_numpy(np.array(jax.random.normal(nkey, shape, jnp.float32))))
    return x_t, noise


@pytest.fixture(scope="module")
def jax_sample(models):
    """The JAX `DynamiCrafter.sample`, jitted once with its DDIM tables as an
    input: `sample` reads eta only through `DDIMSchedule.create`, so handing
    it the eta-0 or eta-1 tables lets both cases share one compiled program."""
    import camc2v_tpu.models.dynamicrafter as jdc

    jm = models[0]

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

    return jax.jit(run)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_sample_matches_jax(models, jax_sample, eta):
    from camc2v_tpu.core.schedules import DDIMSchedule

    jm, params, tm = models
    batch = _batch()
    key = jax.random.key(11)
    ddim = DDIMSchedule.create(jm.schedule, STEPS, SAMPLE_KW["timestep_spacing"], eta)
    ref = np.asarray(jax_sample(params, {k: jnp.asarray(v) for k, v in batch.items()}, key, ddim))
    x_t, noise = _jax_noise(key, (2, 4, 4, 4, 4))
    got = tm.sample(_torch_batch(batch), x_T=x_t, step_noise=noise, ddim_eta=eta, **SAMPLE_KW).numpy()
    assert got.shape == ref.shape == (2, 4, 32, 32, 3)
    assert_close(got, ref)


def test_unet_matches_jax_mid():
    from camc2v_tpu_torch.nn.unet3d import UNetModel

    jm = my_model("dynamicrafter", dims=MID).unet
    t, lat, lctx = MID.T, MID.LAT, 77 + MID.T * 16
    params = jax_params(jm, jnp.zeros((1, t, lat, lat, 8)), jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, lctx, 16)), jnp.ones((1,), jnp.int32))
    x, ctx = _normal(2, t, lat, lat, 8), _normal(2, lctx, 16, seed=2)
    ts, fs = np.array([10, 700], np.int32), np.array([3, 5], np.int32)
    tm = UNetModel(port_config(jm.config, pc.UNetConfig), dtype=torch.float32)
    got, ref = run_both(jm, params, tm, [x, ts, ctx, fs])
    assert got.shape == (2, t, lat, lat, 4)
    assert_close(got, ref)
