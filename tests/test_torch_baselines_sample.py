"""The baselines' `sample` against the JAX package, in a file of two tests
so that xdist (`--dist loadfile`, files queued by their number of tests,
most first) runs it beside `tests/test_tp.py` rather than before it. Moved
from `test_torch_baselines.py`, name kept: `test_sample_matches_jax`, both
families at the oracle TINY dims with the weights of
`test_torch_baselines.baseline_pair`, end to end (2 DDIM steps, eta 1, CFG
7.5 with rescale 0.7, decoded, the noise of the JAX key chain; MotionCtrl's
request with camera CFG 1.5), the JAX side one compiled program per family.
Tolerance: 1e-4 of the output's max |value| (f32, summation order only).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_baselines import FAMILIES, baseline_pair  # noqa: E402
from test_torch_camera_generate import STEPS, batches, jax_noise  # noqa: E402
from test_torch_port_modules import assert_close, jit_o0, one_torch_thread  # noqa: E402,F401

KEY = jax.random.key(13)


def sample_kw(family):
    """2 DDIM steps, eta 1, CFG 7.5 with rescale 0.7; MotionCtrl's request
    also with camera CFG 1.5 (cosine): a third UNet call a step, without
    the payload, so through MotionCtrl's plain branch."""
    return dict(ddim_steps=STEPS, ddim_eta=1.0, guidance_scale=7.5, guidance_rescale=0.7,
                timestep_spacing="uniform_trailing", camera_cfg=1.5 if family == "motionctrl" else 1.0,
                camera_cfg_scheduler="cosine")


@pytest.fixture(scope="module")
def built():
    """family -> (JAX model, seeded JAX parameters, port model holding them,
    {"sample": the JAX `sample`}), the JAX `sample` one compiled program."""
    cache = {}

    def get(family):
        if family not in cache:
            jm, params, tm = baseline_pair(family)
            jb, _ = batches(n_ctx=0)
            ref = jit_o0(lambda p, batch, key: jm.sample(p, batch, key, **sample_kw(family)))(params, jb, KEY)
            cache[family] = jm, params, tm, {"sample": np.asarray(ref)}
        return cache[family]

    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_sample_matches_jax(built, family):
    """`sample` end to end, decoded, on the noise of the JAX key chain
    (`sample_kw`: MotionCtrl's request with camera CFG)."""
    _, _, tm, refs = built(family)
    _, tb = batches(n_ctx=0)
    ref = refs["sample"]
    x_t, noise = jax_noise(KEY, (2, 4, 4, 4, 4))
    got = tm.sample(tb, x_T=x_t, step_noise=noise, **sample_kw(family)).numpy()
    assert got.shape == ref.shape == (2, 4, 32, 32, 3)
    assert float(np.abs(ref).max()) > 0.1
    assert_close(got, ref)
