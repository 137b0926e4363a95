"""The port's model options that the shipped yamls leave off, module by
module, against the JAX package.

Each module runs in f32 on the same numpy inputs with the same seeded,
fully non-zero weights (`test_torch_port_modules.jax_params`, so the
zero-initialised projections are live):

  * `Epipolar` under every mask variant (the hybrid fallbacks, the
    same-frame variants, `only_on_cond_frame`, `is_3d_full_attn`), the level
    masks given to both sides, and on the port also through the request's
    prepared masks (`prepare_masked_epipolar`); every masked call goes
    through the attention seam with a mask;
  * `TemporalTransformer` with the causal mask, relative positions (alone
    and together) and cross-attention to the per-frame context;
  * `ResBlock` with `up` / `down`;
  * `MultiLatentEpipolarAdaptor` with output upscaling, the Plücker input
    ('add', 'concat', and the flag without features, which builds nothing),
    the context positional encoding, and `MultiLatentAdaptor`;
  * `cross_normalization` in both of CamContextI2V's modes.

Tolerance: 1e-4 of the output's max |value| (f32, summation order only).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_modules import _F  # noqa: E402
from test_torch_port_modules import (_normal, assert_close, jax_params, jit_o0, one_torch_thread,  # noqa: E402,F401
                                     run_both)

from camc2v_tpu.camera import geometry as JG  # noqa: E402

from camc2v_tpu_torch import config as pc  # noqa: E402

T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731

EPI_VARIANTS = {
    "hybrid": dict(epipolar_hybrid_attention=True),
    "hybrid_v2": dict(epipolar_hybrid_attention_v2=True),
    "only_self_pixel": dict(only_self_pixel_on_current_frame=True),
    "register_token": dict(current_frame_as_register_token=True),
    "only_on_cond_frame": dict(only_on_cond_frame=True, epipolar_hybrid_attention=True),
    "3d_full_attn": dict(is_3d_full_attn=True),
}


@pytest.fixture
def seam_masks(monkeypatch):
    """The masks the Epipolar module hands the attention seam."""
    from camc2v_tpu_torch.nn import epipolar as seam

    seen = []
    dense = seam.dot_product_attention

    def recorded(*a, **k):
        seen.append(k.get("mask"))
        return dense(*a, **k)

    monkeypatch.setattr(seam, "dot_product_attention", recorded)
    return seen


@pytest.mark.parametrize("variant", list(EPI_VARIANTS))
def test_epipolar_variant_matches_jax(variant, seam_masks):
    from camc2v_tpu.nn.epipolar import Epipolar as JEpipolar
    from camc2v_tpu.nn.epipolar import EpipolarConfig as JCfg
    from camc2v_tpu_torch.nn.epipolar import Epipolar, prepare_masked_epipolar

    t, hw, c, heads = 4, 8, 32, 2
    kw = dict(origin_h=8 * hw, origin_w=8 * hw, attention_resolution=(1,), num_register_tokens=2,
              **EPI_VARIANTS[variant])
    jcfg, tcfg = JCfg(**kw), pc.EpipolarConfig(**kw)
    masks = {8: np.asarray(JG.build_epipolar_masks(_F(t, 8 * hw), t, (hw, hw), jcfg)[8])}
    idx = np.array([2], np.int32)
    feats = _normal(1, t, hw, hw, c)
    jm = JEpipolar(config=jcfg, query_dim=c, heads=heads)
    jkw = dict(masks={8: jnp.asarray(masks[8])}, cond_frame_index=jnp.asarray(idx))
    params = jax_params(jm, jnp.asarray(feats), **jkw)
    tm = Epipolar(tcfg, c, heads)
    tkw = dict(masks={8: T_(masks[8])}, cond_frame_index=T_(idx))
    got, ref = run_both(jm, params, tm, [feats], jkw=jkw, tkw=tkw)
    assert got.shape == (hw * hw, t, c)
    assert_close(got, ref)
    lk = 2 + (hw * hw if tcfg.only_on_cond_frame else t * hw * hw)
    if tcfg.is_3d_full_attn:
        assert seam_masks == [None]
    else:
        assert tuple(seam_masks[0].shape) == (1, 1, t * hw * hw, lk) and bool(seam_masks[0][..., :2].all())
    with torch.no_grad():  # the request's prepared masks give the same attention
        prep = prepare_masked_epipolar(tkw["masks"], tcfg, T_(idx))
        again = tm(T_(feats), prep=prep, cond_frame_index=T_(idx)).numpy()
    np.testing.assert_array_equal(again, got)


TEMPORAL_FORMS = {
    "causal": dict(causal_attention=True),
    "relative_position": dict(relative_position=True),
    "causal_relative": dict(causal_attention=True, relative_position=True),
    "cross_attention": dict(only_self_att=False, context_dim=16),
}


@pytest.mark.parametrize("form", list(TEMPORAL_FORMS))
def test_temporal_transformer_form_matches_jax(form):
    from camc2v_tpu.nn.attention import TemporalTransformer as JTemporal
    from camc2v_tpu_torch.nn.attention import TemporalTransformer

    b, t, hh, c, heads = 2, 4, 4, 32, 2
    kw = TEMPORAL_FORMS[form]
    x = _normal(b, t, hh, hh, c)
    ctx = _normal(b * t, 77 + 16, 16, seed=3) if form == "cross_attention" else None
    jm = JTemporal(in_channels=c, n_heads=heads, d_head=c // heads, temporal_length=t, **kw)
    jargs = [jnp.asarray(x)] + ([jnp.asarray(ctx)] if ctx is not None else [])
    params = jax_params(jm, *jargs)
    tm = TemporalTransformer(c, heads, c // heads, temporal_length=t, **kw)
    got, ref = run_both(jm, params, tm, [x] + ([ctx] if ctx is not None else []))
    assert got.shape == x.shape
    assert_close(got, ref)


@pytest.mark.parametrize("updown", ["up", "down"])
def test_resblock_updown_matches_jax(updown):
    from camc2v_tpu.nn.layers import ResBlock as JResBlock
    from camc2v_tpu_torch.nn.layers import ResBlock

    x, emb = _normal(4, 8, 8, 32), _normal(4, 64, seed=2)
    kw = {updown: True}
    jm = JResBlock(out_channels=32, use_temporal_conv=False, **kw)
    params = jax_params(jm, jnp.asarray(x), jnp.asarray(emb), batch_size=2)
    tm = ResBlock(32, 32, 64, **kw)
    got, ref = run_both(jm, params, tm, [x, emb], jkw=dict(batch_size=2), tkw=dict(batch_size=2))
    assert got.shape == ((4, 16, 16, 32) if updown == "up" else (4, 4, 4, 32))
    assert_close(got, ref)


ADAPTOR_OPTIONS = {
    "output_upscaling": dict(output_queries=32),
    "plucker_add": dict(use_plucker_embedding=True, plucker_embedding_dim=12),
    "plucker_concat": dict(use_plucker_embedding=True, plucker_embedding_dim=12, plucker_input_strategy="concat"),
    "plucker_flag_without_features": dict(use_plucker_embedding=True),
    "context_positional_encoding": dict(context_positional_encoding=True),
}


@pytest.mark.parametrize("option", list(ADAPTOR_OPTIONS))
def test_adaptor_option_matches_jax(option):
    from camc2v_tpu.camera.adaptors import MultiLatentEpipolarAdaptor as JAdaptor
    from camc2v_tpu_torch.camera.adaptors import MultiLatentEpipolarAdaptor

    t, nq, n_frames = 2, 16, 3
    kw = dict(query_dim=32, depth=2, dim_head=16, heads=2, num_queries=nq, embedding_dim=4, output_dim=4,
              num_register_tokens=2, use_mask=True, video_length=t, timestep_embedding_type="sinusoidal_embedded",
              **ADAPTOR_OPTIONS[option])
    x = _normal(1, n_frames * nq, 4)
    mask = np.random.default_rng(5).uniform(size=(1, t * nq, n_frames * nq)) < 0.3
    features = kw.get("plucker_embedding_dim") is not None
    pl = _normal(1, t * nq, 12, seed=4) if features else None
    jm = JAdaptor(**kw)
    jargs = [jnp.asarray(x), jnp.asarray(mask)] + ([jnp.asarray(pl)] if features else [])
    params = jax_params(jm, *jargs)
    assert ("plucker_in" in params) == features
    tm = MultiLatentEpipolarAdaptor(**kw, plucker_features=features)
    got, ref = run_both(jm, params, tm, [x, mask] + ([pl] if features else []))
    per_frame = 4 * nq if option == "output_upscaling" else nq
    assert got.shape == (1, t * per_frame, 4)
    assert_close(got, ref)


def test_multi_latent_adaptor_matches_jax():
    from camc2v_tpu.camera.adaptors import MultiLatentAdaptor as JAdaptor
    from camc2v_tpu_torch.camera.adaptors import MultiLatentAdaptor

    kw = dict(dim=32, depth=2, dim_head=8, heads=4, num_queries=8, embedding_dim=12, output_dim=16, video_length=2)
    x = _normal(2, 40, 12)
    jm = JAdaptor(**kw)
    got, ref = run_both(jm, jax_params(jm, jnp.asarray(x)), MultiLatentAdaptor(**kw), [x])
    assert got.shape == (2, 16, 16)
    assert_close(got, ref)


def test_cross_normalization_matches_jax():
    """Both of CamContextI2V's modes: per channel over (T, h, w) against the
    conditioning latent, and per sample over tokens and channels."""
    from camc2v_tpu.camera.adaptors import cross_normalization as jcn
    from camc2v_tpu_torch.camera.adaptors import cross_normalization

    x, ref_x = 3.0 * _normal(2, 4, 5, 5, 4) + 1.0, _normal(2, 5, 5, 4, seed=2)
    for xa, ra, axes in ((x, ref_x[:, None], (-4, -3, -2)),
                         (x.reshape(2, 1, 100, 4), ref_x.reshape(2, 1, 25, 4), (-2, -1))):
        want = np.asarray(jit_o0(lambda a, r: jcn(a, r, axes=axes))(jnp.asarray(xa), jnp.asarray(ra)))
        got = cross_normalization(T_(xa), T_(ra), axes=axes).numpy()
        assert_close(got, want)
