"""What surrounds the Hopper K9 and K6p, the opt-in routes' kernels, on the CPU.

The kernels run only on the card (`chip_smoke.py` and `tools/routes_ab.py`
hold them against their plain twins there); these tests hold what the CPU
can reach, with the kernels' loops written out in PyTorch:

  * K9's partition (`ops/groupnorm.py::temporal_plan`, which the wrapper
    launches with): every row of every sample falls in exactly one slice and
    one thread's row group, the threads of a row group cover its 16-byte
    pieces, and the grid follows the SM count, over a sweep of
    (B*T, HW, C, SM count);
  * K9's arithmetic: the slices' moments summed block by block in the
    plan's order (each row group in row order, the row groups, then the
    group's channels), the last block's fixed-order combine over the slices
    and the apply equal the JAX `group_norm_fused_temporal` (Pallas interpret
    mode), at T = 1, 3, 16, HW not a multiple of the slices' rows, C = 128,
    320, 1280, SiLU on and off, f32 and bf16;
  * K6p's tile constants: the penalty box of `PenaltyMask`
    (`csrc/epipolar_mask.cuh`) is the core header's BQ query rows by BK keys,
    one 128-byte swizzle row of bf16 keys, and the port's KERNEL_BQ /
    KERNEL_BK are those constants;
  * K6p's forward summed over the non-empty 128 x 64 tiles of the kernels'
    map only, each frame tile's penalties read from penalty batch b % pb,
    equals the JAX `epipolar_flash_attention` with penalties (the Pallas
    `_v2p_kernel` in interpret mode) at batch 2 with pb = 1 and 2 and four
    registers, for 0 / -1e30 penalties and for finite penalties that are not
    a mask (the additive meaning).

Inputs come from numpy with a seed. Tolerances, relative to the reference's
max |value|: 1e-5 in f32 (two f32 algorithms summing in another order;
observed ~1e-7), 4 bf16 ulps (4 * 2^-8) for bf16 outputs (an output may round
to the neighbouring bf16 value).
"""

import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.append(str(Path(__file__).parent / "oracle"))

from test_torch_camera_modules import _F  # noqa: E402
from test_torch_train_step import one_torch_thread  # noqa: E402,F401  (one torch thread for this module)

from camc2v_tpu.ops import epipolar_flash as jef  # noqa: E402
from camc2v_tpu.ops import groupnorm as jgn  # noqa: E402

from camc2v_tpu_torch.ops import epipolar_flash as ef  # noqa: E402
from camc2v_tpu_torch.ops import groupnorm as gn  # noqa: E402

CSRC = Path(ef.__file__).resolve().parent.parent / "csrc"
ULP = 2.0 ** -8
T_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


# ------------------------------------------------------------------ K9's plan

# (B, T, HW, C, bytes per element, SM count): the UNet's 5-D sites at batch 1
# and 2, the VAE's 256^2 view, the deep levels, ragged maps, f32, other cards
PLAN_SWEEP = [(2, 16, 1024, 320, 2, 132), (1, 16, 64, 1280, 2, 132), (16, 16, 4096, 128, 2, 132),
              (2, 3, 63, 320, 2, 132), (3, 1, 7, 1280, 4, 108), (1, 5, 143, 128, 2, 1),
              (4, 16, 256, 640, 4, 132), (2, 16, 16, 2048, 2, 78)]


@pytest.mark.parametrize("b,t,hw,c,elem,sms", PLAN_SWEEP, ids=[str(p) for p in PLAN_SWEEP])
def test_k9_plan_covers_every_row_once(b, t, hw, c, elem, sms):
    rows = t * hw
    plan = gn.temporal_plan(b, rows, c, elem, sms)
    assert plan.pieces * gn.K9_PIECE_BYTES == c * elem and plan.pieces <= gn.K9_MAX_PIECES
    assert plan.pieces * plan.rgroups <= max(gn.K9_THREADS, plan.pieces)  # one block's threads
    # every row of a sample in exactly one (slice, row group)
    hits = np.zeros(rows, np.int64)
    for si in range(plan.splits):
        r0, r1 = gn.slice_rows(rows, plan.splits, si)
        assert r0 <= r1
        for rg in range(plan.rgroups):
            hits[r0 + rg:r1:plan.rgroups] += 1
    assert (hits == 1).all()
    # the grid: one wave of at most K9_BLOCKS_PER_SM blocks per SM, no more
    # slices than leave each thread K9_UNROLL rows
    assert b * plan.splits <= max(b, gn.K9_BLOCKS_PER_SM * sms)
    assert plan.splits == 1 or -(-rows // plan.splits) >= plan.rgroups * gn.K9_UNROLL // 2
    assert plan.splits >= min(gn.K9_BLOCKS_PER_SM * sms // b, rows // (plan.rgroups * gn.K9_UNROLL))


@pytest.mark.parametrize("c,elem", [(100, 2), (6, 4), (8200, 2)], ids=["C=100 bf16", "C=6 f32", "C=8200 bf16"])
def test_k9_plan_refuses_rows_that_are_not_whole_pieces(c, elem):
    with pytest.raises(ValueError, match="16-byte pieces"):
        gn.temporal_plan(1, 64, c, elem, 132)


# ------------------------------------------------------------------ K9's arithmetic

def k9_emulated(x, scale, bias, *, groups, eps, silu, sms):
    """K9's two launches in PyTorch, f32, over x (B, rows, C): per slice and
    row group the f32 sums in row order, the row groups in order, the
    group's channels in order; the last block's combine over the slices in
    order (in the kernel's contiguous ranges); then the apply."""
    b, rows, c = x.shape
    plan = gn.temporal_plan(b, rows, c, x.element_size(), sms)
    xf = x.float()
    cg, vals = c // groups, 2 * groups
    parts = torch.zeros(b, plan.splits, vals)
    for bi in range(b):
        for si in range(plan.splits):
            r0, r1 = gn.slice_rows(rows, plan.splits, si)
            red = torch.zeros(plan.rgroups, 2, c)
            for rg in range(plan.rgroups):
                s = torch.zeros(c)
                q = torch.zeros(c)
                for r in range(r0 + rg, r1, plan.rgroups):
                    s = s + xf[bi, r]
                    q = q + xf[bi, r] * xf[bi, r]
                red[rg, 0], red[rg, 1] = s, q
            chan = red[0].clone()
            for rg in range(1, plan.rgroups):
                chan = chan + red[rg]
            for m in range(2):
                for g in range(groups):
                    acc = torch.zeros(())
                    for ch in range(g * cg, (g + 1) * cg):
                        acc = acc + chan[m, ch]
                    parts[bi, si, m * groups + g] = acc
    threads = plan.pieces * plan.rgroups
    nparts = max(1, threads // vals)
    y = torch.empty_like(xf)
    for bi in range(b):
        ranges = []
        for pi in range(nparts):
            k0, k1 = plan.splits * pi // nparts, plan.splits * (pi + 1) // nparts
            acc = torch.zeros(vals)
            for k in range(k0, k1):
                acc = acc + parts[bi, k]
            ranges.append(acc)
        tot = ranges[0].clone()
        for r in ranges[1:]:
            tot = tot + r
        count = torch.tensor(float(rows * cg))
        mean = tot[:groups] / count
        inv = torch.rsqrt(torch.clamp(tot[groups:] / count - mean * mean, min=0.0) + eps)
        mean_c, inv_c = mean.repeat_interleave(cg), inv.repeat_interleave(cg)
        yb = (xf[bi] - mean_c) * inv_c * scale + bias
        y[bi] = yb * torch.sigmoid(yb) if silu else yb
    return y.to(x.dtype), plan


K9_CASES = [("T=1 C=1280", (2, 1, 5, 7, 1280), 3), ("T=3 C=320", (2, 3, 4, 9, 320), 5),
            ("T=16 C=128", (1, 16, 3, 7, 128), 3)]  # (label, (B, T, H, W, C), SM count)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("silu", [False, True], ids=["no silu", "silu"])
@pytest.mark.parametrize("label,shape,sms", K9_CASES, ids=[c[0] for c in K9_CASES])
def test_k9_kernel_loops_match_pallas_interpret(label, shape, sms, silu, dtype):
    rng = np.random.default_rng(len(label) + int(silu))
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    c = shape[-1]
    s, b = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = T_(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    ref = np.asarray(jgn.group_norm_fused_temporal(jx, jnp.asarray(s), jnp.asarray(b), num_groups=32,
                                                   silu=silu).astype(jnp.float32))
    rows, hw = int(np.prod(shape[1:-1])), shape[2] * shape[3]
    got, plan = k9_emulated(tx.reshape(shape[0], rows, c), T_(s), T_(b), groups=32, eps=1e-5, silu=silu, sms=sms)
    slices = [gn.slice_rows(rows, plan.splits, si) for si in range(plan.splits)]
    # several slices, some starting inside a frame, and row loops with a remainder
    assert plan.splits > 1 and any(r0 % hw for r0, _ in slices)
    assert any((r1 - r0) % (plan.rgroups * gn.K9_UNROLL) for r0, r1 in slices)
    _close(got.float().reshape(shape).numpy(), ref, 1e-5 if dtype == "f32" else 4 * ULP, f"{label} {dtype}")


# ------------------------------------------------------------------ K6p's tiles

def test_penalty_tile_constants_are_the_core_headers():
    core = (CSRC / "flash_hopper.cuh").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (BQ|BK) = (\d+);", core)}
    assert consts == {"BQ": ef.KERNEL_BQ, "BK": ef.KERNEL_BK}
    policy = (CSRC / "epipolar_mask.cuh").read_text()
    pen = policy[policy.index("struct PenaltyMask"):]
    # a ring slot holds rows x BK bf16 penalties; the tensor map's box is BK keys x rows, swizzled by 128 bytes
    assert "static constexpr int stage_size(int rows) { return rows * BK * 2; }" in pen
    assert "const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};" in pen
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in pen and "tile_offset(BQ, r, c)" in pen
    assert ef.KERNEL_BK * 2 == 128  # one tile row of bf16 keys is one 128-byte swizzle row
    # the forward stages BQ query rows a tile: the map is made with BQ-row boxes
    entry = (CSRC / "epipolar_precomp.cu").read_text()
    assert "penalty_map(&tp, pen, pb, Lq, t * hw, BQ)" in entry and "FwdParams<PenaltyMask>" in entry
    assert "flash_core" not in entry and not (CSRC / "flash_core.cuh").exists()


def k6p_over_tiles(q, k, v, pen, tiles, scale, thw):
    """K6p's loop in PyTorch: the online softmax over the non-empty 128 x 64
    tiles of the kernels' map only, per (batch, query tile); a frame tile's
    logits raised by penalty batch b % pb, the register tile's keys plain."""
    b, lq, h, d = q.shape
    lk, pb = k.shape[1], pen.shape[0]
    qs = q * scale
    m = torch.full((b, h, lq), ef.M_FLOOR)
    l = torch.zeros(b, h, lq)
    acc = torch.zeros(b, h, lq, d)
    for bi, qt, kt in tiles.nonzero().tolist():
        rows = slice(qt * ef.KERNEL_BQ, (qt + 1) * ef.KERNEL_BQ)
        j0 = kt * ef.KERNEL_BK
        if j0 >= lk:  # no registers: the key loop ends before the register column
            continue
        cols = slice(j0, min(lk, j0 + ef.KERNEL_BK))
        s = torch.einsum("qhd,khd->hqk", qs[bi, rows], k[bi, cols])
        if j0 < thw:
            s = s + pen[bi % pb, rows, cols].float()
        mn = torch.clamp(torch.maximum(m[bi, :, rows], s.amax(-1)), min=ef.M_FLOOR)
        p = torch.exp(s - mn[..., None])
        alpha = torch.exp(m[bi, :, rows] - mn)
        l[bi, :, rows] = l[bi, :, rows] * alpha + p.sum(-1)
        acc[bi, :, rows] = acc[bi, :, rows] * alpha[..., None] + torch.einsum("hqk,khd->hqd", p, v[bi, cols])
        m[bi, :, rows] = mn
    return (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).permute(0, 2, 1, 3)


T4, H16, DS8, NREG, JBQ, JBK = 4, 16, 8, 4, 128, 256  # 4 frames of 16x16; the JAX call's own tiling


@pytest.mark.parametrize("finite", [False, True], ids=["0 or -1e30", "finite penalties"])
@pytest.mark.parametrize("pb", [1, 2], ids=["pb=1 shared", "pb=2"])
def test_k6p_over_non_empty_tiles_matches_pallas_interpret(pb, finite):
    b, hw = 2, H16 * H16
    thw, lq = T4 * hw, T4 * hw
    F = np.array(_F(T4, H16 * DS8))
    F2 = F.copy()
    F2[:, np.eye(T4, dtype=bool)] = 0  # the second sample: zero-F diagonal (NaN lines)
    lines = jnp.concatenate([jef.epipolar_lines(jnp.asarray(F), H16, H16, DS8),
                             jef.epipolar_lines(jnp.asarray(F2 if pb == 2 else F), H16, H16, DS8)])
    jpen = np.array(jef.materialize_penalties(lines[:pb], T4, H16, H16, DS8, NREG, JBK).astype(jnp.float32))
    rng = np.random.default_rng(pb + 2 * finite)
    if finite:  # additive values on the visible frame pairs, bf16-exact
        add = np.asarray(jnp.asarray(rng.uniform(-3.0, 1.0, jpen.shape), jnp.bfloat16).astype(jnp.float32))
        jpen[..., :thw] = np.where(jpen[..., :thw] == 0, add[..., :thw], jpen[..., :thw])
    q = rng.standard_normal((b, lq, 2, 32)).astype(np.float32)
    kv = rng.standard_normal((2, b, thw + NREG, 2, 32)).astype(np.float32)
    k, v = (np.concatenate([a, np.zeros((b, JBK - NREG, 2, 32), np.float32)], axis=1) for a in kv)
    geom = dict(t=T4, h=H16, w=H16, downsample=DS8, num_registers=NREG)
    jtiles = jef.epipolar_tile_map(lines, T4, H16, H16, DS8, JBQ, JBK)
    ref = np.asarray(jef._epipolar_flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lines, jtiles, jnp.asarray(jpen, jnp.bfloat16), scale=0.125,
        block_q=JBQ, block_k=JBK, **geom))
    assert np.isfinite(ref).all()
    tlines = T_(lines)
    tiles = ef.kernel_tile_map(tlines, T4, H16, H16, DS8)
    assert 0 < tiles[..., :-1].float().mean() < 1  # some frame tiles are skipped
    pen = T_(jpen[..., :thw]).to(torch.bfloat16)  # the port's penalties: the frame columns, the same values
    got = k6p_over_tiles(T_(q), T_(kv[0]), T_(kv[1]), pen, tiles, 0.125, thw)
    _close(got, ref, 1e-5, "K6p over tiles")
    twin = ef.epipolar_attention_precomp_plain(T_(q), T_(kv[0]), T_(kv[1]), pen, t=T4, h=H16, w=H16, scale=0.125)
    _close(twin, ref, 1e-5, "K6p twin")
