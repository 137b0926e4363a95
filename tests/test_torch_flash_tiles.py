"""What surrounds the Hopper flash kernels K2 and K5, on the CPU.

The kernels run only on the card (`chip_smoke.py` holds them against their
plain twins there); these tests hold what the CPU can reach:

  * the tile grid: `ops/flash_attention.py`'s BLOCK_Q and BLOCK_K are the
    core header's BQ and BK (`csrc/flash_hopper.cuh`, parsed);
  * the wrapper's view of a mask (`_tiles`): the mask zero-padded to whole
    tiles and the map of its non-empty tiles on the kernels' grid, exactly
    the tiles holding a set bit, with ragged Lq and Lk and a (1, Lq, Lk) mask
    broadcast over the batch;
  * tile skipping is exact: the forward and backward summed over the map's
    non-empty tiles only (the kernels' loops, written out in PyTorch) equal
    the plain twins, fully masked rows included;
  * K5's pre-pass: its plain version (`bwd_prepass_plain`: qs, delta) equals
    the JAX backward's own formulas (`camc2v_tpu/ops/flash_attention.py::
    _flash_bwd_impl`) on the same numpy inputs, qs bitwise in bf16 and delta
    within 1e-6 of its scale in f32.

Inputs come from numpy with a seed. Tolerances: 1e-5 of the reference's max
|value| where two f32 algorithms sum in another order (observed ~1e-7).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camc2v_tpu_torch.ops import flash_attention as fa

HEADER = Path(fa.__file__).resolve().parent.parent / "csrc" / "flash_hopper.cuh"


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


def test_tile_constants_are_the_core_headers():
    text = HEADER.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (BQ|BK) = (\d+);", text)}
    assert consts == {"BQ": fa.BLOCK_Q, "BK": fa.BLOCK_K}


MAP_CASES = [  # (label, B, mask batch, Lq, Lk)
    ("CLIP text 77x77 shared", 3, 1, 77, 77),
    ("CLIP vision 257x257", 2, 2, 257, 257),
    ("ds32 epipolar 1024 over 1028", 2, 2, 1024, 1028),
    ("ragged 200 over 1028, shared", 2, 1, 200, 1028),
    ("one tile 128x64", 1, 1, 128, 64),
]


@pytest.mark.parametrize("label,b,bm,lq,lk", MAP_CASES, ids=[c[0] for c in MAP_CASES])
def test_tile_map_marks_exactly_the_tiles_with_a_set_bit(label, b, bm, lq, lk):
    rng = np.random.default_rng(lq * 7 + lk)
    mask = rng.uniform(size=(bm, lq, lk)) < 0.002  # sparse: most tiles empty
    mask[:, : min(lq, 5), : min(lk, 3)] = True
    mask[:, lq - 1, lk - 1] = True  # the ragged corner tile
    padded, tiles = fa._tiles(torch.from_numpy(mask), b, lq, lk)
    nq, nk = -(-lq // fa.BLOCK_Q), -(-lk // fa.BLOCK_K)
    assert tuple(padded.shape) == (bm, nq * fa.BLOCK_Q, nk * fa.BLOCK_K) and padded.dtype == torch.bool
    np.testing.assert_array_equal(padded[:, :lq, :lk].numpy(), mask)
    assert not padded[:, lq:].any() and not padded[:, :, lk:].any()
    assert tuple(tiles.shape) == (b, nq, nk) and tiles.dtype == torch.uint8 and tiles.is_contiguous()
    want = np.zeros((b, nq, nk), np.uint8)
    for bi in range(b):
        for i in range(nq):
            for j in range(nk):
                block = mask[bi % bm, i * fa.BLOCK_Q:(i + 1) * fa.BLOCK_Q, j * fa.BLOCK_K:(j + 1) * fa.BLOCK_K]
                want[bi, i, j] = block.any()
    np.testing.assert_array_equal(tiles.numpy(), want)
    assert want.any()


def _tile_blocks(tiles):
    """(b, query rows, key columns) of each non-empty tile of the map."""
    for bi, qt, kt in tiles.nonzero().tolist():
        yield bi, slice(qt * fa.BLOCK_Q, (qt + 1) * fa.BLOCK_Q), slice(kt * fa.BLOCK_K, (kt + 1) * fa.BLOCK_K)


def _forward_over_tiles(q, k, v, mask, scale):
    """K2's loop in PyTorch: the online softmax over the map's non-empty
    tiles only, per (batch, query tile), in f32."""
    b, lq, h, _ = q.shape
    padded, tiles = fa._tiles(mask, b, lq, k.shape[1])
    qs = q * scale
    m = torch.full((b, h, lq), fa.M_FLOOR)
    l = torch.zeros(b, h, lq)
    acc = torch.zeros(b, h, lq, q.shape[-1])
    for bi, rows, cols in _tile_blocks(tiles):
        s = torch.einsum("qhd,khd->hqk", qs[bi, rows], k[bi, cols])
        s = torch.where(padded[bi % padded.shape[0], rows, cols][:s.shape[1], :s.shape[2]], s, fa.NEG_INF)
        mn = torch.clamp(torch.maximum(m[bi, :, rows], s.amax(-1)), min=fa.M_FLOOR)
        p = torch.exp(s - mn[..., None])
        alpha = torch.exp(m[bi, :, rows] - mn)
        l[bi, :, rows] = l[bi, :, rows] * alpha + p.sum(-1)
        acc[bi, :, rows] = acc[bi, :, rows] * alpha[..., None] + torch.einsum("hqk,khd->hqd", p, v[bi, cols])
        m[bi, :, rows] = mn
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).permute(0, 2, 1, 3)
    return out, torch.where(l == 0, torch.full_like(l, fa.LSE_MASKED), m + torch.log(l))


def _backward_over_tiles(q, k, v, mask, out, lse, dout, scale):
    """K5's two sweeps in PyTorch over the map's non-empty tiles only, f32."""
    b, lq, _, _ = q.shape
    padded, tiles = fa._tiles(mask, b, lq, k.shape[1])
    qs, delta = fa.bwd_prepass_plain(q, out, dout, scale)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for bi, rows, cols in _tile_blocks(tiles):
        s = torch.einsum("qhd,khd->hqk", qs[bi, rows], k[bi, cols])
        vis = padded[bi % padded.shape[0], rows, cols][:s.shape[1], :s.shape[2]]
        p = torch.where(vis, torch.exp(s - lse[bi, :, rows][..., None]), 0.0)
        dp = torch.einsum("qhd,khd->hqk", dout[bi, rows], v[bi, cols])
        ds = p * (dp - delta[bi, :, rows][..., None])
        dq[bi, rows] += torch.einsum("hqk,khd->qhd", ds, k[bi, cols]) * scale
        dk[bi, cols] += torch.einsum("hqk,qhd->khd", ds, qs[bi, rows])
        dv[bi, cols] += torch.einsum("hqk,qhd->khd", p, dout[bi, rows])
    return dq, dk, dv


SKIP_CASES = [  # (label, B, mask batch, Lq, Lk)
    ("per-batch mask 257 over 300", 2, 2, 257, 300),
    ("shared mask 200 over 1028", 2, 1, 200, 1028),
    ("causal 300 (the CLIP text mask's form)", 2, 1, 300, 300),
]


def _skip_inputs(b, bm, lq, lk, h=2, d=16):
    rng = np.random.default_rng(lq + lk)
    q, dout = (torch.from_numpy(rng.standard_normal((b, lq, h, d)).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, lk, h, d)).astype(np.float32)) for _ in range(2))
    if bm == 1 and lq == lk:
        mask = np.tril(np.ones((lq, lk), bool))[None]
    else:
        mask = rng.uniform(size=(bm, lq, lk)) < 0.3
        mask[:, : fa.BLOCK_Q, fa.BLOCK_K: 3 * fa.BLOCK_K] = False  # empty tiles
        mask[:, fa.BLOCK_Q:, : fa.BLOCK_K] = False
        mask[:, [3, 130, lq - 1]] = False  # fully masked rows
    return q, k, v, torch.from_numpy(mask), dout


@pytest.mark.parametrize("label,b,bm,lq,lk", SKIP_CASES, ids=[c[0] for c in SKIP_CASES])
def test_forward_over_non_empty_tiles_equals_the_twin(label, b, bm, lq, lk):
    q, k, v, mask, _ = _skip_inputs(b, bm, lq, lk)
    assert not fa._tiles(mask, b, lq, lk)[1].all()  # some tiles are skipped
    out, lse = _forward_over_tiles(q, k, v, mask, 0.25)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, 0.25)
    _close(out, ref_out, 1e-5, "out")
    dead = ref_lse >= fa.LSE_MASKED
    assert bool((lse[dead] == fa.LSE_MASKED).all()) and bool((lse >= fa.LSE_MASKED).eq(dead).all())
    _close(lse[~dead], ref_lse[~dead], 1e-5, "lse")


@pytest.mark.parametrize("label,b,bm,lq,lk", SKIP_CASES, ids=[c[0] for c in SKIP_CASES])
def test_backward_over_non_empty_tiles_equals_the_twin(label, b, bm, lq, lk):
    q, k, v, mask, dout = _skip_inputs(b, bm, lq, lk)
    out, lse = fa.flash_fwd_plain(q, k, v, mask, 0.25)
    got = _backward_over_tiles(q, k, v, mask, out, lse, dout, 0.25)
    ref = fa.flash_bwd_plain(q, k, v, mask, out, lse, dout, 0.25)
    for name, g, r in zip("qkv", got, ref):
        _close(g, r, 1e-5, f"d{name}")


@pytest.mark.parametrize("d", [64, 80])
def test_prepass_plain_matches_the_jax_backward_formulas(d):
    """`_flash_bwd_impl`: qs = q * asarray(scale, q.dtype) and delta =
    sum(f32(dout) * f32(out), -1), on the same bf16 inputs."""
    rng = np.random.default_rng(d)
    b, lq, h = 2, 77, 3
    q, out, dout = (rng.standard_normal((b, lq, h, d)).astype(np.float32) for _ in range(3))
    scale = d ** -0.5
    jq, jout, jdout = (jnp.asarray(x, jnp.bfloat16) for x in (q, out, dout))
    ref_qs = np.asarray((jq * jnp.asarray(scale, jq.dtype)).astype(jnp.float32))
    ref_delta = np.asarray(jnp.sum(jdout.astype(jnp.float32) * jout.astype(jnp.float32), axis=-1)).transpose(0, 2, 1)
    tq, tout, tdout = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                       for x in (jq, jout, jdout))
    qs, delta = fa.bwd_prepass_plain(tq, tout, tdout, scale)
    assert qs.dtype == torch.bfloat16 and tuple(qs.shape) == (b, lq, h, d)
    np.testing.assert_array_equal(qs.float().numpy(), ref_qs)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (b, h, lq) and delta.is_contiguous()
    _close(delta.numpy(), ref_delta, 1e-6, "delta")
