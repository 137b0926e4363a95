"""The port's camera geometry and the plain side of K6 against the JAX package.

Geometry (`camera/geometry.py`) runs in f32 on both sides: poses, Plücker
rays and fundamental matrices agree within 1e-4 of the output's max |value|;
epipolar lines the same (NaN where F == 0, on both sides); the kernel tile
maps exactly. The materialised mask may differ only on near-threshold bits
(|dist - thresh| < 1e-4 * thresh, where the two libraries' operation orders
round to opposite sides); those are counted and bounded.

K6's plain twin (`ops.epipolar_flash.epipolar_flash_attention` on CPU
tensors) is held to the JAX Pallas kernel `_epipolar_flash_fwd_impl` in
interpret mode, fed the same lines, at the JAX tests' small geometry (B 1,
T 4, 8x8, ds 8, 4 registers, 64-query / 64-key tiles), with a key tile that
spans all four frames, with zero-F frame pairs, and with every row masked.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from refload import make_batch  # noqa: E402
from test_torch_port_modules import assert_close  # noqa: E402

from camc2v_tpu.camera import geometry as JG  # noqa: E402
from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402

from camc2v_tpu_torch.camera import geometry as TG  # noqa: E402
from camc2v_tpu_torch.config import EpipolarConfig  # noqa: E402
from camc2v_tpu_torch.ops import epipolar_flash as tef  # noqa: E402

T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def bench_poses(b=1, t=16, n_ctx=2, img=256):
    """The flagship request's camera trajectory (bench.py:_e2e_setup)."""
    K = np.array([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (b, t, 1, 1))
    w2c[..., 0, 3] = np.linspace(0, 1, t)[None]
    w2c[..., 1, 3] = 0.05
    w2c_cond = np.tile(np.eye(4, dtype=np.float32), (b, n_ctx, 1, 1))
    w2c_cond[..., 0, 3] = -0.3
    return np.broadcast_to(K, (b, t, 3, 3)).copy(), w2c, w2c_cond


def bench_F(perturb=True):
    """(1, 16, 16, 3, 3) F of every frame pair of the bench trajectory, with
    the JAX key-0 perturbation of the zero-translation pairs."""
    K, w2c, _ = bench_poses()
    c2w = np.linalg.inv(w2c)
    pairs = JG.relative_c2w_pairs(jnp.asarray(c2w))
    tv = pairs[..., :3, 3:4]
    if perturb:
        tv = JG.add_small_perturbation(tv, jax.random.key(0))
    return JG.fundamental_matrix(jnp.broadcast_to(jnp.asarray(K)[:, None], (1, 16, 16, 3, 3)), pairs[..., :3, :3], tv)


@jax.jit
def _jax_pose_geometry(K, c2w, RT, RTc, idx):
    """The JAX side of the pose checks, one compiled program."""
    rel = JG.relative_pose(c2w, idx)
    pairs = JG.relative_c2w_pairs(rel)
    tv = pairs[..., :3, 3:4]
    noise = jax.random.normal(jax.random.key(0), tv.shape, jnp.float32)
    tv_p = JG.add_small_perturbation(tv, jax.random.key(0))
    Kp = jnp.broadcast_to(K[:, None], (2, 4, 4, 3, 3))
    return dict(
        rel=rel, pairs=pairs, noise=noise, tv_p=tv_p,
        plucker=JG.plucker_embedding(K, rel, 32, 32), rays=JG.plucker_embedding(K, rel, 32, 32, return_plucker=False),
        F=JG.fundamental_matrix(Kp, pairs[..., :3, :3], tv_p), Fc=JG.conditional_fundamental(K, RT, RTc, idx),
    )


def test_pose_geometry_matches_jax():
    nb = make_batch(b=2, n_ctx=2, seed=1)
    K, RT, RTc = nb["camera_intrinsics"], nb["RT"], nb["RT_cond"]
    idx = np.array([0, 2])
    c2w = np.linalg.inv(RT)
    j = {k: np.asarray(v) for k, v in _jax_pose_geometry(*(jnp.asarray(a) for a in (K, c2w, RT, RTc, idx))).items()}
    assert_close(TG.relative_pose(T_(c2w), T_(idx)).numpy(), j["rel"])
    assert_close(TG.relative_c2w_pairs(T_(j["rel"])).numpy(), j["pairs"])
    assert_close(TG.plucker_embedding(T_(K), T_(j["rel"]), 32, 32).numpy(), j["plucker"])
    assert_close(TG.plucker_embedding(T_(K), T_(j["rel"]), 32, 32, return_plucker=False).numpy(), j["rays"])
    # the perturbation draws are handed over: zero translations (the diagonal)
    # become 1e-6 * noise on both sides (elementwise relative: the diagonal is
    # 1e-6 of the rest)
    tv_t = TG.add_small_perturbation(T_(j["pairs"][..., :3, 3:4]), T_(j["noise"]))
    diag = np.abs(j["tv_p"]) < 1e-5
    assert diag[:, np.arange(4), np.arange(4)].all() and diag.sum() == 2 * 4 * 3
    np.testing.assert_allclose(tv_t.numpy(), j["tv_p"], rtol=1e-6, atol=0)
    Kp = np.broadcast_to(K[:, None], (2, 4, 4, 3, 3))
    F_t = TG.fundamental_matrix(T_(Kp), T_(j["pairs"][..., :3, :3]), tv_t)
    assert_close(F_t.numpy() / np.abs(j["F"]).max(), j["F"] / np.abs(j["F"]).max())
    Fc_t = TG.conditional_fundamental(T_(K), T_(RT), T_(RTc), T_(idx))
    assert Fc_t.shape == (2, 4, 3, 3, 3)
    assert_close(Fc_t.numpy() / np.abs(j["Fc"]).max(), j["Fc"] / np.abs(j["Fc"]).max())
    # the per-level materialised masks (each side from its own F), the oracle
    # TINY levels: pixel ds 16 and 8 at 32x32
    from camc2v_tpu.nn.epipolar import EpipolarConfig as JCfg

    kw = dict(origin_h=32, origin_w=32, attention_resolution=(2, 1))
    masks_j = JG.build_epipolar_masks(jnp.asarray(j["F"]), 4, (4, 4), JCfg(**kw))
    masks_t = TG.build_epipolar_masks(F_t, 4, (4, 4), EpipolarConfig(**kw))
    assert sorted(masks_t) == sorted(masks_j) == [8, 16]
    for ds, mt in masks_t.items():
        h = 32 // ds
        lines_j = np.asarray(jef.epipolar_lines(jnp.asarray(j["F"]), h, h, ds))
        assert_near_threshold_only(mt.numpy(), np.asarray(masks_j[ds]), lines_j, h, h, ds, f"TINY ds{ds}")


def assert_near_threshold_only(mask_t, mask_j, lines_j, h, w, ds, label):
    """The masks differ only on bits whose |dist - thresh| < 1e-4 * thresh
    (dist in f64 from the JAX lines), and on at most 1e-4 of the bits."""
    thresh = ds * math.sqrt(2.0) / 2.0
    y, x = np.meshgrid(np.arange(h) * ds + ds / 2 - 0.5, np.arange(w) * ds + ds / 2 - 0.5, indexing="ij")
    diff = np.argwhere(mask_j != mask_t)
    for bi, qi, ki in diff:
        frame, pix = divmod(int(ki), h * w)
        a, b_, c = lines_j[bi, qi, frame].astype(np.float64)
        dist = abs(a * x.reshape(-1)[pix] + b_ * y.reshape(-1)[pix] + c)
        assert abs(dist - thresh) < 1e-4 * thresh, (label, bi, qi, ki, dist)
    print(f"{label}: {len(diff)} of {mask_t.size} mask bits differ, all near the threshold")
    assert len(diff) <= 1e-4 * mask_t.size, (label, len(diff))


# (label, F source, t, h, w, ds): the UNet's ds8 and ds16 levels (the ds16
# canonical tile spans four frames) and the adaptor's 3 key frames
LAYOUTS = [("unet ds8", "pairs", 16, 32, 32, 8), ("unet ds16", "pairs", 16, 16, 16, 16),
           ("adaptor", "cond", 3, 32, 32, 8)]


def _layout_F(src):
    if src == "pairs":
        return bench_F()
    K, w2c, w2c_cond = bench_poses()
    return JG.conditional_fundamental(jnp.asarray(K), jnp.asarray(w2c), jnp.asarray(w2c_cond),
                                      jnp.zeros((1,), jnp.int32))


_jlines = jax.jit(jef.epipolar_lines, static_argnums=(1, 2, 3))
_jtiles = jax.jit(jef.epipolar_tile_map, static_argnums=(1, 2, 3, 4, 5, 6))
_jmask = jax.jit(jef.materialize_mask, static_argnums=(1, 2, 3, 4))


@pytest.mark.parametrize("label,src,t,h,w,ds", LAYOUTS, ids=[x[0] for x in LAYOUTS])
def test_lines_tile_maps_and_masks_match_jax(label, src, t, h, w, ds):
    F = _layout_F(src)
    lines_j = np.asarray(_jlines(F, h, w, ds))
    lines_t = tef.epipolar_lines(T_(F), h, w, ds).numpy()
    nan = np.isnan(lines_j)
    np.testing.assert_array_equal(np.isnan(lines_t), nan)
    assert nan.any() == (label != "unet ds8" and label != "unet ds16")  # the cond frame's own F is 0
    assert_close(np.where(nan, 0, lines_t), np.where(nan, 0, lines_j))

    # tile maps from the same lines: exact
    block_k = jef.choose_block_k(h * w)
    assert tef.choose_block_k(h * w) == block_k
    assert tef.kernel_tiling_ok(t, h * w, block_k) == jef.kernel_tiling_ok(t, h * w, block_k) is True
    tiles_j = np.asarray(_jtiles(jnp.asarray(lines_j), t, h, w, ds, jef.BLOCK_Q, block_k))
    tiles_t = tef.epipolar_tile_map(T_(lines_j), t, h, w, ds, tef.BLOCK_Q, block_k).numpy()
    assert tiles_t.dtype == np.int32
    np.testing.assert_array_equal(tiles_t, tiles_j)
    assert 0 < tiles_t.mean() < 1

    # K6's work counts: the pairs its bound needs (set bits) lie inside the
    # subtiles the map leaves on
    work = dict(heads=2, t=t, num_registers=4)
    needed = tef.mask_pairs(T_(lines_t), h=h, w=w, downsample=ds, **work)
    assert 0 < needed <= tef.visible_pairs(T_(tiles_t), hw=h * w, block_k=block_k, **work)

    # masks of the first two query frames: each side from its own lines (and,
    # at ds8, the JAX geometry module's matmul form), near-threshold bits only
    lq = 2 * h * w
    lines_j, lines_t = lines_j[:, :lq], lines_t[:, :lq]
    mask_j = np.asarray(_jmask(jnp.asarray(lines_j), t, h, w, ds))
    mask_t = tef.materialize_mask(T_(lines_t), t, h, w, ds).numpy()
    if label == "unet ds8":
        ref = np.asarray(JG.epipolar_mask(F[:, :2], t, h, w, ds, EpipolarConfig()))
        np.testing.assert_array_equal(ref.shape, mask_t.shape)
        mask_j = np.stack([mask_j, ref])
    for mj in mask_j.reshape(-1, *mask_t.shape):
        assert_near_threshold_only(mask_t, mj, lines_j, h, w, ds, label)
    assert tef.mask_pairs(T_(lines_t), h=h, w=w, downsample=ds, **work) == (int(mask_t.sum()) + lq * 4) * 2


# ------------------------------------------------------- K6's plain twin

B, T, H, W, DS, R = 1, 4, 8, 8, 8, 4
HW = H * W
LQ = T * HW
BQ = BK = 64


def _small_F(zero_pairs=None):
    """The JAX tests' small geometry: a trajectory with distinct
    translations, perturbed with JAX key 1 (tests/test_epipolar_flash.py)."""
    K = np.array([[H * DS, 0, H * DS / 2], [0, W * DS, W * DS / 2], [0, 0, 1]], np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    for i in range(T):
        c2w[:, i, 0, 3] = 0.4 * i + 0.05
        c2w[:, i, 1, 3] = 0.1 * i
        c2w[:, i, 2, 3] = -0.15 * i
    pairs = JG.relative_c2w_pairs(jnp.asarray(c2w))
    tv = JG.add_small_perturbation(pairs[..., :3, 3:4], jax.random.key(1))
    F = JG.fundamental_matrix(jnp.broadcast_to(jnp.asarray(K), (B, T, T, 3, 3)), pairs[..., :3, :3], tv)
    if zero_pairs is not None:
        F = jnp.where(jnp.asarray(zero_pairs)[None, :, :, None, None], 0.0, F)
    return F


# (label, key tile, registers, zeroed frame pairs)
TWIN_CASES = [
    ("frame tiles", BK, R, None),
    ("multi-frame tile", 4 * HW, R, None),
    ("zero-F diagonal", BK, R, np.eye(T, dtype=bool)),
    ("every row masked", BK, 0, np.ones((T, T), bool)),
]


@pytest.mark.parametrize("label,block_k,nreg,zero", TWIN_CASES, ids=[c[0] for c in TWIN_CASES])
def test_k6_twin_matches_pallas_interpret(label, block_k, nreg, zero):
    lines = jef.epipolar_lines(_small_F(zero), H, W, DS)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, LQ, 2, 64)).astype(np.float32)
    kv = rng.standard_normal((2, B, LQ + nreg, 2, 64)).astype(np.float32)
    k, v = (np.concatenate([a, np.zeros((B, block_k - nreg, 2, 64), np.float32)], axis=1) for a in kv)
    geom = dict(t=T, h=H, w=W, downsample=DS, num_registers=nreg)
    tiles = jef.epipolar_tile_map(lines, T, H, W, DS, BQ, block_k)
    ref = np.asarray(jef._epipolar_flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lines, tiles, scale=0.125, block_q=BQ, block_k=block_k,
        **geom))
    # the port's keys stop after the registers; the Pallas kernel's are padded to a block_k tile
    got = tef.epipolar_flash_attention(T_(q), T_(kv[0]), T_(kv[1]), T_(lines), block_q=BQ, block_k=block_k,
                                       **geom)
    assert np.isfinite(ref).all()
    if label == "every row masked":
        assert not np.abs(ref).any() and not got.abs().any()
    else:
        assert_close(got.numpy(), ref)


def test_k6_wrapper_rejects_other_layouts():
    lines = torch.zeros(B, LQ, T, 3)
    q = torch.zeros(B, LQ, 2, 64)
    k = torch.zeros(B, LQ + R, 2, 64)
    geom = dict(t=T, h=H, w=W, downsample=DS, num_registers=R, block_q=BQ)
    with pytest.raises(ValueError, match="Lk"):  # keys padded to a block_k tile, the Pallas layout
        tef.epipolar_flash_attention(q, torch.zeros(B, LQ + BK, 2, 64), torch.zeros(B, LQ + BK, 2, 64), lines,
                                     block_k=BK, **geom)
    with pytest.raises(ValueError, match="Lk"):
        tef.epipolar_flash_attention(q, k[:, :-1], k[:, :-1], lines, block_k=BK, **geom)
    with pytest.raises(ValueError, match="lines"):
        tef.epipolar_flash_attention(q, k, k, lines[:, :, :2], block_k=BK, **geom)
    with pytest.raises(ValueError, match="tile"):
        tef.epipolar_flash_attention(q, k, k, lines, block_k=BK, t=T, h=H, w=W, downsample=DS,
                                     num_registers=R, block_q=96)

