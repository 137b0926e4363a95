"""`CamContextI2V.prepare_batch` under the context strategies and options
that the shipped yamls leave off, against the JAX package, at the oracle
TINY dims (the plain model of `test_torch_camera_generate.py::plain_tiny`,
the same seeded, non-zero weights on both sides):

  * 'max' and 'avg': the conditioning and context frames' image tokens
    pooled over the frames, without and with the validity flags of a padded
    context (`cond_frames_valid`); the port writes no `c_crossattn_mask`
    for the pooled tokens (a recorded divergence: the JAX package writes one
    sized from the pooled length, which does not match its c_crossattn);
  * cross-normalisation of the adaptor's output in both modes
    ('spatio_temporal', 'token').

Tolerance: 1e-4 of each output's max |value| (f32). In a file of three
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

from test_torch_camera_generate import batches, perturb_draws, plain_tiny, seeded_params_for  # noqa: E402
from test_torch_port_modules import assert_close, jit_o0, one_torch_thread, port_config  # noqa: E402,F401


def _models(**kw):
    from camc2v_tpu_torch.models.camcontexti2v import CamContextI2V

    base = plain_tiny("camcontext")
    jm = type(base)(dataclasses.replace(base.config, **kw), dtype=jnp.float32)
    tm = CamContextI2V(port_config(jm.config), dtype=torch.float32)
    return jm, tm, seeded_params_for(tm, seed=4)


def _padded(jb, tb):
    """The batch with its second sample's last context slot padded (a zero
    frame, the identity pose, flagged invalid)."""
    jb, tb = dict(jb), dict(tb)
    valid = np.array([[True, True], [True, False]])
    frames, poses = np.array(jb["cond_frames"]), np.array(jb["RT_cond"])
    frames[1, 1], poses[1, 1] = 0.0, np.eye(4)
    for d, conv in ((jb, jnp.asarray), (tb, lambda a: torch.from_numpy(np.array(a)))):
        d["cond_frames"], d["RT_cond"], d["cond_frames_valid"] = conv(frames), conv(poses), conv(valid)
    return jb, tb


def _prepare_both(jm, tm, params, jb, tb):
    run = jit_o0(lambda p, b: jm.prepare_batch(p, b, None, need_full_z=False))
    _, jc = run(params, jb)
    with torch.no_grad():
        _, tc = tm.prepare_batch(tb, perturb_noise=perturb_draws(2, 4))
    return jc, tc


@pytest.mark.parametrize("strategy", ["max", "avg"])
def test_pooled_strategy_matches_jax(strategy):
    jm, tm, params = _models(multi_cond_strategy=strategy)
    assert tm.adaptor is None and "adaptor" not in params
    jb, tb = batches(n_ctx=2)
    for jbatch, tbatch in ((jb, tb), _padded(jb, tb)):
        jc, tc = _prepare_both(jm, tm, params, jbatch, tbatch)
        assert tc["c_crossattn"].shape == (2, 77 + 16 * 4, 16)  # one frame's 16 x T image tokens
        for key in ("c_crossattn", "c_concat"):
            assert_close(tc[key].numpy(), np.asarray(jc[key]))
        assert "c_crossattn_mask" not in tc
        if "cond_frames_valid" in tbatch:  # the JAX mask, sized from the pooled length, fits nothing
            assert jc["c_crossattn_mask"].shape[1] != jc["c_crossattn"].shape[1]
    # the padded slot is left out: sample 1 pools as with its one real context frame
    one = {k: v[:, :1] if k in ("cond_frames", "RT_cond") else v for k, v in tb.items()}
    with torch.no_grad():
        _, tc_one = tm.prepare_batch(one, perturb_noise=perturb_draws(2, 4))
    assert_close(tc["c_crossattn"][1].numpy(), tc_one["c_crossattn"][1].numpy())


def test_cross_normalization_matches_jax():
    for mode in ("spatio_temporal", "token"):
        jm, tm, params = _models(use_cross_normalization=True, cross_normalization_mode=mode)
        jc, tc = _prepare_both(jm, tm, params, *batches(n_ctx=2))
        assert tc["c_concat"].shape == (2, 4, 4, 4, 4)
        assert_close(tc["c_concat"].numpy(), np.asarray(jc["c_concat"]))
