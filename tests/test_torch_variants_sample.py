"""`CamContextI2V.sample` end to end with a mask variant, against the JAX
package: the oracle TINY CamContextI2V with its own epipolar config
(`epipolar_hybrid_attention`) and the zero-translation perturbation (a
frame against itself has a translation of rounding noise, whose epipolar
lines, and so the hybrid fallback of their rows, are chaotic in floating
point; the perturbation makes them the shared draws'), 2 context frames, 2
DDIM steps, CFG 7.5 with rescale 0.7, eta 1, decoded to pixels; the same
seeded, non-zero weights, the same noise from the JAX key chain and the
same perturbation draws (the helpers of `test_torch_camera_generate.py`). Every level's mask and
the adaptor's dense conditional mask carry the hybrid fallback: the port's
payload holds the level masks and their K2 form (`prepare_masked_epipolar`).

Tolerance: 1e-5 of the output's max |value| (f32, summation order only).
The one JAX `sample` program of this slice; in a file of one test, which
the tier-1 run starts beside `test_tp.py`.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import my_model  # noqa: E402
from test_torch_camera_generate import SAMPLE_KW, batches, jax_noise, perturb_draws, seeded_params_for  # noqa: E402
from test_torch_port_modules import assert_close, jit_o0, one_torch_thread, port_config  # noqa: E402,F401


def test_hybrid_epipolar_sample_matches_jax():
    from camc2v_tpu.core.schedules import DDIMSchedule
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V

    base = my_model("camcontext")
    c = base.config
    assert c.epipolar.epipolar_hybrid_attention
    epi = dataclasses.replace(c.epipolar, add_small_perturbation_on_zero_T=True)
    cfg = dataclasses.replace(c, epipolar=epi, unet=dataclasses.replace(c.unet, epipolar=epi),
                              clip_text=dataclasses.replace(c.clip_text, layers=2),
                              resampler=dataclasses.replace(c.resampler, embedding_dim=c.clip_vision.width))
    jm = type(base)(cfg, dtype=jnp.float32)
    tm = CamContextI2V(port_config(cfg), dtype=torch.float32)
    params = seeded_params_for(tm, seed=2)
    jb, tb = batches(n_ctx=2)
    key = jax.random.key(12)
    ddim = DDIMSchedule.create(jm.schedule, 2, SAMPLE_KW["timestep_spacing"], 1.0)
    import camc2v_tpu.models.dynamicrafter as jdc

    def run(p, batch, k):
        class Given:
            @staticmethod
            def create(*_a, **_k):
                return ddim

        real, jdc.DDIMSchedule = jdc.DDIMSchedule, Given
        try:
            return jm.sample(p, batch, k, **SAMPLE_KW)
        finally:
            jdc.DDIMSchedule = real

    ref = np.asarray(jit_o0(run)(params, jb, key))
    x_t, noise = jax_noise(key, (2, 4, 4, 4, 4))
    _, cond = tm.prepare_batch(tb, perturb_noise=perturb_draws(2, 4))
    cam = cond["camera"]
    assert "F" not in cam and sorted(cam["masks"]) == sorted(cam["epi_prep"]) == [8, 16]
    got = tm.sample(tb, x_T=x_t, step_noise=noise, ddim_eta=1.0, perturb_noise=perturb_draws(2, 4),
                    **SAMPLE_KW).numpy()
    assert got.shape == ref.shape == (2, 4, 32, 32, 3)
    assert float(np.abs(ref).max()) > 0.1
    assert_close(got, ref, tol=1e-5)
