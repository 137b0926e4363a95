"""What surrounds the Hopper epipolar kernels K6 and K7, on the CPU.

The kernels run only on the card (`chip_smoke.py` holds them against their
plain twins there); these tests hold what the CPU can reach:

  * the skip map at the kernels' own tiling (`kernel_tile_map`: 128-query
    rows, 64-key subtiles) equals the JAX package's `epipolar_tile_map` at
    the same tiling bit for bit, on the bench trajectory's geometry at ds16
    and at a ds8 level cut to 4 frames, and with NaN lines (F == 0);
  * the map is exactly safe (every tile holding a set bit of the
    materialised mask is marked) and never marks more than the JAX-tiling
    map (each marked tile lies in a marked 256 x 256 subtile);
  * the tile grid: `ops/epipolar_flash.py`'s KERNEL_BQ and KERNEL_BK are the
    Hopper core header's BQ and BK (`csrc/flash_hopper.cuh`, parsed);
  * tile skipping is exact: the forward and backward summed over the map's
    non-empty tiles only (the kernels' loops, written out in PyTorch) equal
    the plain twins, fully masked rows included;
  * K7's pre-pass: its plain version (`bwd_prepass_plain`: qs, delta) equals
    the JAX backward's own formulas (`camc2v_tpu/ops/epipolar_flash.py::
    _epipolar_flash_bwd_impl`) at the epipolar shapes, qs bitwise in bf16 and
    delta within 1e-6 of its scale in f32.

Inputs come from numpy with a seed (JAX's geometry for the maps, the lines
handed to both sides). Tolerances: 1e-5 of the reference's max |value| where
two f32 algorithms sum in another order (observed ~1e-7).
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_geometry import bench_F  # noqa: E402
from test_torch_camera_modules import _F  # noqa: E402

from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402

from camc2v_tpu_torch.ops import epipolar_flash as ef  # noqa: E402
from camc2v_tpu_torch.ops import flash_attention as fa  # noqa: E402

HEADER = Path(ef.__file__).resolve().parent.parent / "csrc" / "flash_hopper.cuh"
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
_jlines = jax.jit(jef.epipolar_lines, static_argnums=(1, 2, 3))
_jtiles = jax.jit(jef.epipolar_tile_map, static_argnums=(1, 2, 3, 4, 5, 6))


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


def test_tile_constants_are_the_core_headers():
    text = HEADER.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (BQ|BK) = (\d+);", text)}
    assert consts == {"BQ": ef.KERNEL_BQ, "BK": ef.KERNEL_BK}


# (label, t, h = w, ds, perturbed): the UNet's ds16 level, a ds8 level cut
# to 4 frames, and 4 frames at ds16 whose same-frame pairs have F == 0
MAP_LAYOUTS = [("ds16", 16, 16, 16, True), ("ds8 cut to 4 frames", 4, 32, 8, True),
               ("ds16 zero-F same-frame pairs, 4 frames", 4, 16, 16, False)]


def _layout_lines(t, h, ds, perturb):
    """(1, t*h*h, t, 3) f32 lines of the bench trajectory's first t frames, from JAX."""
    F = bench_F(perturb)[:, :t, :t]
    return np.asarray(_jlines(F, h, h, ds))


@pytest.mark.parametrize("label,t,h,ds,perturb", MAP_LAYOUTS, ids=[c[0] for c in MAP_LAYOUTS])
def test_kernel_tile_map_matches_jax_at_the_kernel_tiling(label, t, h, ds, perturb):
    lines = _layout_lines(t, h, ds, perturb)
    assert np.isnan(lines).any() == (not perturb)
    ref = np.asarray(_jtiles(jnp.asarray(lines), t, h, h, ds, ef.KERNEL_BQ, ef.KERNEL_BK))
    got = ef.kernel_tile_map(T_(lines), t, h, h, ds)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, t * h * h // 128, t * h * h // 64 + 1)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[..., -1].all() and 0 < got[..., :-1].float().mean() < 1  # the register column, and skips


@pytest.mark.parametrize("label,t,h,ds,perturb", MAP_LAYOUTS, ids=[c[0] for c in MAP_LAYOUTS])
def test_kernel_tile_map_is_safe_and_finer_than_the_jax_tiling(label, t, h, ds, perturb):
    lines = T_(_layout_lines(t, h, ds, perturb))
    hw = h * h
    fine = ef.kernel_tile_map(lines, t, h, h, ds)[0]
    bk = ef.choose_block_k(hw)
    coarse = ef.epipolar_tile_map(lines, t, h, h, ds, ef.BLOCK_Q, bk)[0]
    sub = min(ef.SUBTILE, bk, hw)
    mask = ef.materialize_mask(lines, t, h, h, ds)[0]  # (Lq, t*hw)
    nq, nk = mask.shape[0] // ef.KERNEL_BQ, mask.shape[1] // ef.KERNEL_BK
    held = mask.view(nq, ef.KERNEL_BQ, nk, ef.KERNEL_BK).any(dim=3).any(dim=1)
    assert held.any()
    assert bool(fine[:, :nk][held].all()), "a tile holding a set mask bit is skipped"
    # each marked tile, the register column included, lies in a marked subtile of the JAX-tiling map
    qi, ki = fine.nonzero(as_tuple=True)
    assert bool(coarse[qi * ef.KERNEL_BQ // ef.BLOCK_Q, ki * ef.KERNEL_BK // sub].all())
    work = dict(heads=1, t=t, hw=hw, num_registers=4)
    assert ef.visible_pairs(fine[None], block_q=ef.KERNEL_BQ, block_k=ef.KERNEL_BK, **work) < \
        ef.visible_pairs(coarse[None], block_k=bk, **work)


# ------------------------------------------------ tile skipping is exact

def _tile_mask(lines, t, h, w, ds, nreg):
    """(B, Lq, t*hw + nreg) bool mask K6 computes, registers last."""
    mask = ef.materialize_mask(lines, t, h, w, ds)
    return torch.cat([mask, torch.ones(*mask.shape[:2], nreg, dtype=torch.bool)], dim=-1)


def _tile_blocks(tiles, lk):
    """(b, query rows, key columns) of each non-empty tile of the map that
    holds keys (without registers the kernels' key loop ends before the
    register column)."""
    for bi, qt, kt in tiles.nonzero().tolist():
        if kt * ef.KERNEL_BK < lk:
            yield (bi, slice(qt * ef.KERNEL_BQ, (qt + 1) * ef.KERNEL_BQ),
                   slice(kt * ef.KERNEL_BK, min(lk, (kt + 1) * ef.KERNEL_BK)))


def _forward_over_tiles(q, k, v, mask, tiles, scale):
    """K6's loop in PyTorch: the online softmax over the map's non-empty
    tiles only, per (batch, query tile), in f32."""
    b, lq, h, _ = q.shape
    qs = q * scale
    m = torch.full((b, h, lq), ef.M_FLOOR)
    l = torch.zeros(b, h, lq)
    acc = torch.zeros(b, h, lq, q.shape[-1])
    for bi, rows, cols in _tile_blocks(tiles, k.shape[1]):
        s = torch.einsum("qhd,khd->hqk", qs[bi, rows], k[bi, cols])
        s = torch.where(mask[bi, rows, cols], s, ef.NEG_INF)
        mn = torch.clamp(torch.maximum(m[bi, :, rows], s.amax(-1)), min=ef.M_FLOOR)
        p = torch.exp(s - mn[..., None])
        alpha = torch.exp(m[bi, :, rows] - mn)
        l[bi, :, rows] = l[bi, :, rows] * alpha + p.sum(-1)
        acc[bi, :, rows] = acc[bi, :, rows] * alpha[..., None] + torch.einsum("hqk,khd->hqd", p, v[bi, cols])
        m[bi, :, rows] = mn
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).permute(0, 2, 1, 3)
    return out, torch.where(l == 0, torch.full_like(l, ef.LSE_MASKED), m + torch.log(l))


def _backward_over_tiles(q, k, v, mask, tiles, out, lse, dout, scale):
    """K7's two sweeps in PyTorch over the map's non-empty tiles only, f32."""
    qs, delta = fa.bwd_prepass_plain(q, out, dout, scale)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for bi, rows, cols in _tile_blocks(tiles, k.shape[1]):
        s = torch.einsum("qhd,khd->hqk", qs[bi, rows], k[bi, cols])
        p = torch.where(mask[bi, rows, cols], torch.exp(s - lse[bi, :, rows][..., None]), 0.0)
        dp = torch.einsum("qhd,khd->hqk", dout[bi, rows], v[bi, cols])
        ds = p * (dp - delta[bi, :, rows][..., None])
        dq[bi, rows] += torch.einsum("hqk,khd->qhd", ds, k[bi, cols]) * scale
        dk[bi, cols] += torch.einsum("hqk,qhd->khd", ds, qs[bi, rows])
        dv[bi, cols] += torch.einsum("hqk,qhd->khd", p, dout[bi, rows])
    return dq, dk, dv


SKIP_CASES = [  # (label, registers, query frames whose F is zeroed)
    ("3 frames of 16x16, 4 registers", 4, 0),
    ("query frame 0 blind, no registers (fully masked rows)", 0, 1),
]
T3, H16, DS8 = 3, 16, 8


def _skip_inputs(nreg, blind):
    F = np.array(_F(T3, H16 * DS8))
    F[:, :blind] = 0
    lines = ef.epipolar_lines(T_(F), H16, H16, DS8)
    rng = np.random.default_rng(nreg + blind)
    lq, lk = T3 * H16 * H16, T3 * H16 * H16 + nreg
    q, dout = (T_(rng.standard_normal((1, lq, 2, 16)).astype(np.float32)) for _ in range(2))
    k, v = (T_(rng.standard_normal((1, lk, 2, 16)).astype(np.float32)) for _ in range(2))
    tiles = ef.kernel_tile_map(lines, T3, H16, H16, DS8)
    assert not tiles.all()  # some tiles are skipped
    kw = dict(t=T3, h=H16, w=H16, downsample=DS8, num_registers=nreg, scale=0.25)
    return q, k, v, dout, lines, tiles, _tile_mask(lines, T3, H16, H16, DS8, nreg), kw


@pytest.mark.parametrize("label,nreg,blind", SKIP_CASES, ids=[c[0] for c in SKIP_CASES])
def test_forward_and_backward_over_non_empty_tiles_equal_the_twins(label, nreg, blind):
    q, k, v, dout, lines, tiles, mask, kw = _skip_inputs(nreg, blind)
    out, lse = _forward_over_tiles(q, k, v, mask, tiles, 0.25)
    ref_out, ref_lse = ef.epipolar_attention_plain(q, k, v, lines, return_lse=True, **kw)
    _close(out, ref_out, 1e-5, "out")
    dead = ref_lse >= ef.LSE_MASKED
    assert bool(dead.any()) == bool(blind)
    assert bool((lse[dead] == ef.LSE_MASKED).all()) and bool((lse >= ef.LSE_MASKED).eq(dead).all())
    assert not out.permute(0, 2, 1, 3)[dead].any()
    _close(lse[~dead], ref_lse[~dead], 1e-5, "lse")
    got = _backward_over_tiles(q, k, v, mask, tiles, ref_out, ref_lse, dout, 0.25)
    ref = ef.epipolar_bwd_plain(q, k, v, lines, ref_out, ref_lse, dout, **kw)
    for name, g, r in zip("qkv", got, ref):
        _close(g, r, 1e-5, f"d{name}")


# ------------------------------------------------ K7's pre-pass

@pytest.mark.parametrize("b,lq,h", [(1, 4096, 10), (2, 1024, 8)], ids=["ds16 (1,4096,10,64)", "adaptor-like (2,1024,8,64)"])
def test_prepass_plain_matches_the_jax_epipolar_backward_formulas(b, lq, h):
    """`_epipolar_flash_bwd_impl`: qs = q * asarray(scale, q.dtype) and
    delta = sum(f32(dout) * f32(out), -1), on the same bf16 inputs."""
    rng = np.random.default_rng(lq + h)
    d, scale = 64, 64 ** -0.5
    jq, jout, jdout = (jnp.asarray(rng.standard_normal((b, lq, h, d)).astype(np.float32), jnp.bfloat16)
                       for _ in range(3))
    ref_qs = np.asarray((jq * jnp.asarray(scale, jq.dtype)).astype(jnp.float32))
    ref_delta = np.asarray(jnp.sum(jdout.astype(jnp.float32) * jout.astype(jnp.float32), axis=-1)).transpose(0, 2, 1)
    tq, tout, tdout = (T_(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16) for x in (jq, jout, jdout))
    qs, delta = fa.bwd_prepass_plain(tq, tout, tdout, scale)
    assert qs.dtype == torch.bfloat16 and tuple(qs.shape) == (b, lq, h, d)
    np.testing.assert_array_equal(qs.float().numpy(), ref_qs)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (b, h, lq) and delta.is_contiguous()
    _close(delta.numpy(), ref_delta, 1e-6, "delta")
