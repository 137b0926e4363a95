"""The UNet's options that the shipped yamls leave off, in the whole UNet at
the oracle TINY dims, against the JAX UNet (the pattern of
`test_torch_unet_training.py::test_unet_matches_jax`):

  * `resblock_updown`: ResBlocks with `down` / `up` in place of the
    resamplers, their parameters carried across by name;
  * `use_causal_attention` with `use_relative_position` in every temporal
    transformer (init_attn keeps no causal mask, as in JAX);
  * `temporal_selfatt_only=False`: the temporal transformers' attn2 over
    the per-frame text context.

Tolerance: 1e-4 of the output's max |value| (f32). In a file of three
tests, which the tier-1 run starts beside `test_tp.py`.
"""

import dataclasses
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import TINY, my_model  # noqa: E402
from test_torch_port_modules import (_normal, assert_close, jax_params, one_torch_thread, port_config,  # noqa: E402,F401
                                     run_both)

from camc2v_tpu_torch import config as pc  # noqa: E402

OPTIONS = {
    "resblock_updown": dict(resblock_updown=True),
    "causal_relative": dict(use_causal_attention=True, use_relative_position=True),
    "temporal_cross_attention": dict(temporal_selfatt_only=False),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_unet_option_matches_jax(option):
    from camc2v_tpu_torch.nn.unet3d import UNetModel

    base = my_model("dynamicrafter", dims=TINY).unet
    jm = type(base)(dataclasses.replace(base.config, **OPTIONS[option]), dtype=base.dtype)
    t, lat, lctx = TINY.T, TINY.LAT, 77 + TINY.T * 16
    params = jax_params(jm, jnp.zeros((1, t, lat, lat, 8)), jnp.zeros((1,), jnp.int32),
                        jnp.zeros((1, lctx, 16)), jnp.ones((1,), jnp.int32))
    if jm.config.resblock_updown:
        down, up = ([k for k in params if k.endswith(end)] for end in ("_down", "_up"))
        assert len(down) == len(up) == 1  # one level change at TINY
        assert all("emb_proj" in params[k] and "temporal_conv" not in params[k] for k in down + up)
    x, ctx = _normal(2, t, lat, lat, 8), _normal(2, lctx, 16, seed=2)
    ts, fs = np.array([10, 700], np.int32), np.array([3, 5], np.int32)
    tm = UNetModel(port_config(jm.config, pc.UNetConfig), dtype=torch.float32)
    got, ref = run_both(jm, params, tm, [x, ts, ctx, fs])
    assert got.shape == (2, t, lat, lat, 4)
    assert_close(got, ref)
