"""The epipolar mask variants of the port (`camera/geometry.py`) against the
JAX package's `epipolar_mask`, `build_epipolar_masks` and
`conditional_epipolar_mask`.

Two checks per variant, on the same fundamental matrices:
  * the variant logic alone, exactly: the port's `apply_mask_variants` on
    the JAX plain band gives the JAX variant mask bit for bit;
  * end to end: the port's masks (its own plain band, then the variant)
    differ from the JAX masks only inside the (query pixel, key frame) rows
    where the two plain bands differ, and those differ only on bits within
    1e-4 of the threshold (`test_torch_camera_geometry.py::
    assert_near_threshold_only`, the recorded rule: such bits are chaotic in
    floating point, and a hybrid row with one of them may fall back to full
    attention on one side only).
The same-frame variants on the adaptor's T x (1 + N) frame pairs raise on
both sides, and so do soft masks.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_geometry import assert_near_threshold_only  # noqa: E402
from test_torch_camera_modules import _F  # noqa: E402
from test_torch_port_modules import jit_o0  # noqa: E402

from camc2v_tpu.camera import geometry as JG  # noqa: E402
from camc2v_tpu.nn.epipolar import EpipolarConfig as JCfg  # noqa: E402
from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402

from camc2v_tpu_torch.camera import geometry as TG  # noqa: E402
from camc2v_tpu_torch.config import EpipolarConfig  # noqa: E402

T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731

VARIANTS = {
    "hybrid": dict(epipolar_hybrid_attention=True),
    "hybrid_v2": dict(epipolar_hybrid_attention_v2=True),
    "only_self_pixel": dict(only_self_pixel_on_current_frame=True),
    "register_token": dict(current_frame_as_register_token=True),
    "all_four": dict(epipolar_hybrid_attention=True, epipolar_hybrid_attention_v2=True,
                     only_self_pixel_on_current_frame=True, current_frame_as_register_token=True),
}
IMG, T = 64, 4


def _rows_with_band_differences(plain_t, plain_j, t2, hw):
    """(B, Lq, T2) bool: the (query, key frame) rows where the bands differ."""
    b, lq, _ = plain_t.shape
    return (plain_t != plain_j).reshape(b, lq, t2, hw).any(-1)


PLAIN = dict(origin_h=IMG, origin_w=IMG, attention_resolution=(2, 1))


@pytest.fixture(scope="module")
def level_bands():
    """(F, the JAX plain band per level, the JAX lines per level, the port's
    plain band per level): the variant-free half of every case."""
    F = np.asarray(_F(T, IMG, seed=1))
    bands_j, lines_j = jit_o0(lambda f: (
        JG.build_epipolar_masks(f, T, (IMG // 8, IMG // 8), JCfg(**PLAIN)),
        {ds: jef.epipolar_lines(f, IMG // ds, IMG // ds, ds) for ds in (8, 16)}))(jnp.asarray(F))
    bands_t = TG.build_epipolar_masks(T_(F), T, (IMG // 8, IMG // 8), EpipolarConfig(**PLAIN))
    return (F, {ds: np.asarray(b) for ds, b in bands_j.items()}, {ds: np.asarray(v) for ds, v in lines_j.items()},
            bands_t)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_level_masks_match_jax(variant, level_bands):
    F, bands_j, lines_j, bands_t = level_bands
    kw = dict(PLAIN, **VARIANTS[variant])
    masks_j = jit_o0(lambda f: JG.build_epipolar_masks(f, T, (IMG // 8, IMG // 8), JCfg(**kw)))(jnp.asarray(F))
    masks_t = TG.build_epipolar_masks(T_(F), T, (IMG // 8, IMG // 8), EpipolarConfig(**kw))
    assert sorted(masks_t) == sorted(masks_j) == [8, 16]
    for ds, mt in masks_t.items():
        h = IMG // ds
        mj, band_j = np.asarray(masks_j[ds]), bands_j[ds]
        logic = TG.apply_mask_variants(T_(band_j), T, h * h, EpipolarConfig(**kw)).numpy()
        np.testing.assert_array_equal(logic, mj, err_msg=f"{variant} ds{ds}: variant logic")
        assert_near_threshold_only(bands_t[ds].numpy(), band_j, lines_j[ds], h, h, ds, f"{variant} ds{ds}")
        rows = _rows_with_band_differences(bands_t[ds].numpy(), band_j, T, h * h)
        differ = (mt.numpy() != mj).reshape(1, T * h * h, T, h * h).any(-1)
        if VARIANTS[variant].get("epipolar_hybrid_attention_v2"):  # v2 falls back over every key frame
            rows = np.broadcast_to(rows.any(-1, keepdims=True), rows.shape)
        assert not (differ & ~rows).any(), f"{variant} ds{ds}: a row differs where the bands agree"
        assert mj.any() and not mj.all()


@pytest.mark.parametrize("variant", ["hybrid", "hybrid_v2"])
def test_conditional_mask_variants_match_jax(variant):
    """The adaptor's target x [cond | context] mask: the hybrid variants."""
    rng = np.random.default_rng(2)
    b, n_ctx = 2, 2
    K = np.broadcast_to(np.array([[IMG, 0, IMG / 2], [0, IMG, IMG / 2], [0, 0, 1]], np.float32), (b, T, 3, 3))
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, T, 1, 1))
    w2c[:, :, :3, 3] = rng.normal(0, 0.4, (b, T, 3))
    w2c_c = np.tile(np.eye(4, dtype=np.float32), (b, n_ctx, 1, 1))
    w2c_c[:, :, :3, 3] = rng.normal(0, 0.4, (b, n_ctx, 3))
    idx = np.array([0, 2], np.int32)
    args = [K, w2c, w2c_c, idx]
    kw = VARIANTS[variant]
    mj, band_j = map(np.asarray, jit_o0(lambda *a: [JG.conditional_epipolar_mask(*a, IMG, IMG, 8, c)
                                                    for c in (JCfg(**kw), JCfg())])(*map(jnp.asarray, args)))
    hw = (IMG // 8) ** 2
    assert mj.shape == (b, T * hw, (1 + n_ctx) * hw)
    logic = TG.apply_mask_variants(T_(band_j), T, hw, EpipolarConfig(**kw)).numpy()
    np.testing.assert_array_equal(logic, mj)
    mt = TG.conditional_epipolar_mask(*map(T_, args), IMG, IMG, 8, EpipolarConfig(**kw)).numpy()
    band_t = TG.conditional_epipolar_mask(*map(T_, args), IMG, IMG, 8, EpipolarConfig()).numpy()
    rows = _rows_with_band_differences(band_t, band_j, 1 + n_ctx, hw)
    if variant == "hybrid_v2":
        rows = np.broadcast_to(rows.any(-1, keepdims=True), rows.shape)
    assert not ((mt != mj).reshape(b, T * hw, 1 + n_ctx, hw).any(-1) & ~rows).any()


def test_same_frame_variants_on_context_frames_and_soft_masks_raise_in_both():
    """The same-frame variants need T x T frame pairs: on the adaptor's
    T x (1 + N) pairs the JAX broadcast raises, and so does the port; soft
    masks raise on both sides."""
    F = np.asarray(_F(T, IMG))[:, :, :3]  # T query frames over 3 key frames
    for kw in (dict(only_self_pixel_on_current_frame=True), dict(current_frame_as_register_token=True)):
        with pytest.raises((TypeError, ValueError)):  # at trace time: nothing runs
            jit_o0(lambda f: JG.epipolar_mask(f, T, 8, 8, 8, JCfg(**kw)))(jnp.asarray(F))
        with pytest.raises(ValueError, match="same-frame variants"):
            TG.epipolar_mask(T_(F), T, 8, 8, 8, EpipolarConfig(**kw))
    F = np.asarray(_F(T, IMG))
    with pytest.raises(NotImplementedError, match="soft"):
        jit_o0(lambda f: JG.epipolar_mask(f, T, 8, 8, 8, JCfg(apply_epipolar_soft_mask=True)))(jnp.asarray(F))
    with pytest.raises(NotImplementedError, match="soft"):
        TG.epipolar_mask(T_(F), T, 8, 8, 8, EpipolarConfig(apply_epipolar_soft_mask=True))
