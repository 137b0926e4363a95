"""What surrounds the Hopper K4 (LayerNorm + GEGLU feed-forward) and K3
(temporal MHA) kernels, on the CPU.

The kernels run only on the card (`chip_smoke.py` holds them against their
plain twins at every site of a UNet call there); these tests hold what the
CPU can reach:

  * the tiling the wrappers read (rows, columns and k-columns of a tile,
    ring depths, head dim, rows of a warpgroup) is the sources' own
    (`csrc/gemm_hopper.cuh`, `csrc/geglu_ff.cu`, `csrc/temporal_attention.cu`,
    parsed);
  * K4's three phases written out in PyTorch at the kernels' tiling (the LN
    pass to bf16 `xn`; GEMM 1 over 128-row tiles pairing 128 `a` columns
    with their 128 `g` columns, k in stages of 64, the GEGLU epilogue to a
    bf16 hidden layer; GEMM 2 with bias and f32 residual over 160-column
    tiles where 160 divides C, else 128-column ones, the last ragged) equal
    the plain twin `ff_plain`;
  * K3's tiling written out the same way (128-row tiles of whole sequences,
    per head a 192-column [q|k|v] accumulator, per 64-row warpgroup a
    64 x 64 score tile under the block-diagonal sequence mask, P and o
    rounded to bf16, the out-projection) equals `mha_plain` at T = 16, 8 and
    32 with N not a multiple of the sequences per tile; a neighbouring
    sequence of huge values changes no other sequence's output, and the
    padded rows' attention output stays zero;
  * every K3 and K4 site of the flagship CamContextI2V-256 UNet at full
    width, enumerated from `presets.camcontexti2v_256`'s widths, is one the
    kernels take; K3's sequence rule is `nn/attention.py::_fused_mha_ok`'s;
    the wrappers raise on shapes the kernels do not take.

Inputs come from numpy with a seed. Tolerance against the twins: 2 bf16 ulps
(2 * 2^-8) of the output's max |value|, as the twin tests: the emulations sum
over k in another order (stages of 64) than the twins, so an intermediate
rounded to bf16 may round the other way.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from camc2v_tpu_torch import ops, presets
from camc2v_tpu_torch.nn import attention as nn_attention
from camc2v_tpu_torch.ops import _gemm
from camc2v_tpu_torch.ops import geglu_ff as gff
from camc2v_tpu_torch.ops import temporal_attention as ta
from camc2v_tpu_torch.ops.layernorm import layer_norm_plain

CSRC = Path(gff.__file__).resolve().parent.parent / "csrc"
ULP = 2.0 ** -8


def _close(got, ref, tol=2 * ULP):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape
    err = (got - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item(), (err, ref.abs().max().item())


def _consts(path: Path) -> dict:
    text = path.read_text()
    found = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)}
    found.update({m.group(1): int(m.group(2)) for m in re.finditer(r"#define (\w+_STAGES) (\d+)", text)})
    return found


def test_tile_constants_are_the_sources():
    core = _consts(CSRC / "gemm_hopper.cuh")
    ff = _consts(CSRC / "geglu_ff.cu")
    mha = _consts(CSRC / "temporal_attention.cu")
    assert core["BM"] == _gemm.BLOCK_M
    assert core["BK"] == _gemm.BLOCK_K == gff.BLOCK_K == ta.BLOCK_K
    assert (core["OUT_WIDE"], core["OUT_NARROW"]) == _gemm.OUT_TILES
    assert [_gemm.out_tile(c) for c in (320, 512, 640, 1280, 64, 192)] == [160, 128, 160, 160, 128, 128]
    assert core["BM"] // core["CONSUMERS"] == ta.WG_ROWS
    assert core["OUT_STAGES"] == _gemm.OUT_STAGES
    assert ff["GEGLU_STAGES"] == gff.GEGLU_STAGES and mha["QKV_STAGES"] == ta.QKV_STAGES
    assert mha["D"] == ta.HEAD_DIM
    assert ff["HID"] == gff.HIDDEN_TILE


# ---------------------------------------------------------------- K4 at the kernels' tiling


def _gemm_tile(a, w, k_stage=gff.BLOCK_K):
    """(rows, K) @ (n, K)^T in f32, summed over k in stages of 64."""
    acc = torch.zeros(a.shape[0], w.shape[0])
    for k0 in range(0, a.shape[1], k_stage):
        acc += a[:, k0:k0 + k_stage].float() @ w[:, k0:k0 + k_stage].float().t()
    return acc


def _pad_rows(t, multiple):
    pad = -t.shape[0] % multiple
    return torch.cat([t, t.new_zeros(pad, *t.shape[1:])]) if pad else t


def _bias_residual(a, w, bias, res, rows, splits=1):
    """The out GEMM over 128-row tiles of 160 columns where 160 divides n,
    else 128 (the last column tile ragged: its missing weight rows are zeros,
    its columns past n dropped); with splits > 1 each part of K sums its
    k-stages alone and the parts are added before the bias and residual."""
    n = w.shape[0]
    bm, bn = _gemm.BLOCK_M, _gemm.out_tile(n)
    out = torch.empty(a.shape[0], n, dtype=torch.bfloat16)
    wp = _pad_rows(w, bn)
    biasp = torch.cat([bias.float(), bias.new_zeros(-n % bn).float()])
    part = a.shape[1] // splits
    for tm in range(a.shape[0] // bm):
        rs = slice(tm * bm, (tm + 1) * bm)
        for tn in range(wp.shape[0] // bn):
            cs = slice(tn * bn, (tn + 1) * bn)
            v = sum(_gemm_tile(a[rs, p * part:(p + 1) * part], wp[cs, p * part:(p + 1) * part])
                    for p in range(splits)) + biasp[cs]
            live = min(n - tn * bn, bn)
            v = v[:, :live]
            if res is not None:
                v = v + _pad_rows(res, bm)[rs, tn * bn:tn * bn + live].float()
            out[rs, tn * bn:tn * bn + live] = v.to(torch.bfloat16)
    return out[:rows]


def k4_emulated(x, ls, lb, wp, bp, wf, bf, *, eps, splits):
    """K4's phases at the kernels' tiling, GEMM 2's K in `splits` parts."""
    rows, c = x.shape
    inner = wf.shape[1]
    hid = gff.HIDDEN_TILE
    xn = _pad_rows(layer_norm_plain(x, ls, lb, eps=eps), _gemm.BLOCK_M)  # TMA reads rows past `rows` as zeros
    hidden = torch.empty(xn.shape[0], inner, dtype=torch.bfloat16)
    for tm in range(xn.shape[0] // _gemm.BLOCK_M):
        rs = slice(tm * _gemm.BLOCK_M, (tm + 1) * _gemm.BLOCK_M)
        for tn in range(inner // hid):
            w = torch.cat([wp[tn * hid:(tn + 1) * hid], wp[inner + tn * hid:inner + (tn + 1) * hid]])
            acc = _gemm_tile(xn[rs], w)
            a = acc[:, :hid] + bp[tn * hid:(tn + 1) * hid]
            g = acc[:, hid:] + bp[inner + tn * hid:inner + (tn + 1) * hid]
            hidden[rs, tn * hid:(tn + 1) * hid] = (a * (g * 0.5 * (1.0 + torch.erf(g / math.sqrt(2.0))))).to(
                torch.bfloat16)
    return _bias_residual(hidden, wf, bf, x, rows, splits)


def _ff_inputs(rows, c, inner, seed):
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dt)  # noqa: E731
    bf = torch.bfloat16
    return (t(rng.normal(0.3, 1.5, (rows, c)), bf), t(rng.normal(1.0, 0.2, c)), t(rng.normal(0.0, 0.2, c)),
            t(rng.normal(0, c ** -0.5, (2 * inner, c)), bf), t(rng.normal(0, 0.1, 2 * inner)),
            t(rng.normal(0, inner ** -0.5, (c, inner)), bf), t(rng.normal(0, 0.1, c)))


# (rows, C, parts of GEMM 2's K): ragged rows and a ragged 128-column tile;
# 160-column tiles; K in 2, 4 and 8 parts
K4_CASES = [(300, 64, 1), (128, 192, 1), (77, 320, 1), (50, 512, 2), (50, 512, 4), (50, 512, 8)]


@pytest.mark.parametrize("rows,c,splits", K4_CASES)
def test_k4_tiling_matches_the_twin(rows, c, splits):
    inner = 4 * c
    args = _ff_inputs(rows, c, inner, rows + c)
    got = k4_emulated(*args, eps=1e-5, splits=splits)
    _close(got, gff.ff_plain(*args, inner=inner, eps=1e-5))


# (rows, n, k, SMs, parts): the plan at the flagship sites (K4's GEMM 2 over
# the 4C hidden layer at ds1, ds4 and the 4 x 4 middle block at batch 1; K3's
# out-projection, K = C, at ds4) and on a small card
SPLIT_PLANS = [(16384, 320, 1280, 132, 1), (1024, 1280, 5120, 132, 2), (256, 1280, 5120, 132, 4),
               (1024, 1280, 1280, 132, 1), (50, 512, 2048, 132, 2), (50, 512, 2048, 4, 1)]


@pytest.mark.parametrize("rows,n,k,sms,splits", SPLIT_PLANS)
def test_out_gemm_splits_k_only_where_its_tiles_are_few(rows, n, k, sms, splits):
    assert _gemm.out_splits(rows, n, k, sms) == splits
    row_tiles = -(-rows // 128)
    tiles_n = -(-n // _gemm.out_tile(n))
    parts = row_tiles * tiles_n * splits
    assert parts <= max(sms, row_tiles * tiles_n)  # never more than one wave of parts
    assert (k // 64) % splits == 0 and (splits == 1 or k // 64 // splits >= _gemm.MIN_PART_STEPS)


# ---------------------------------------------------------------- K3 at the kernels' tiling


def k3_emulated(x, wq, wk, wv, wo, bo, ls, lb, *, heads, scale, residual, eps):
    """K3's tiles written out; returns the output and the padded (rows, inner)
    attention output o (the kernels' scratch, padded rows included)."""
    n, t, c = x.shape
    rows, inner, d = n * t, wq.shape[0], ta.HEAD_DIM
    x2 = x.reshape(rows, c)
    xb = layer_norm_plain(x2, ls, lb, eps=eps) if ls is not None else x2
    xb = _pad_rows(xb, _gemm.BLOCK_M)
    o = torch.zeros(xb.shape[0], inner, dtype=torch.bfloat16)
    seq = torch.arange(ta.WG_ROWS) // t  # whole sequences in a warpgroup's rows
    same = seq[:, None] == seq[None, :]
    for tm in range(xb.shape[0] // _gemm.BLOCK_M):
        for h in range(heads):
            hs = slice(h * d, (h + 1) * d)
            qkv = _gemm_tile(xb[tm * _gemm.BLOCK_M:(tm + 1) * _gemm.BLOCK_M], torch.cat([wq[hs], wk[hs], wv[hs]]))
            qkv = qkv.to(torch.bfloat16).float()
            for wg in range(_gemm.BLOCK_M // ta.WG_ROWS):
                r = slice(wg * ta.WG_ROWS, (wg + 1) * ta.WG_ROWS)
                q, k, v = qkv[r, :d], qkv[r, d:2 * d], qkv[r, 2 * d:]
                s = torch.where(same, (q @ k.t()) * scale, torch.tensor(-1e30))
                e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
                p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16)
                row0 = tm * _gemm.BLOCK_M + wg * ta.WG_ROWS
                o[row0:row0 + ta.WG_ROWS, hs] = (p.float() @ v).to(torch.bfloat16)
    out = _bias_residual(o, wo, bo, x2 if residual else None, rows)
    return out.reshape(n, t, -1), o


def _mha_inputs(n, t, c, seed, ln):
    rng = np.random.default_rng(seed)
    t_ = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(dt)  # noqa: E731
    x = t_(rng.normal(size=(n, t, c)), torch.bfloat16)
    ws = [t_(rng.normal(0, c ** -0.5, (c, c)), torch.bfloat16) for _ in range(4)]
    bo = t_(rng.normal(0, 0.1, c))
    ls = t_(rng.normal(1.0, 0.2, c)) if ln else None
    lb = t_(rng.normal(0.0, 0.2, c)) if ln else None
    return x, ws, bo, ls, lb


@pytest.mark.parametrize("n,t,c,ln", [(9, 16, 128, True), (37, 8, 64, False), (5, 32, 128, True),
                                      (21, 16, 64, False)])
def test_k3_tiling_matches_the_twin(n, t, c, ln):
    heads = c // ta.HEAD_DIM
    x, ws, bo, ls, lb = _mha_inputs(n, t, c, n * t + c, ln)
    assert n % (_gemm.BLOCK_M // t)  # a ragged last tile of whole sequences
    kw = dict(heads=heads, scale=ta.HEAD_DIM ** -0.5, residual=ln, eps=1e-5)
    got, o = k3_emulated(x, *ws, bo, ls, lb, **kw)
    _close(got, ta.mha_plain(x, *ws, bo, ls, lb, **kw))
    assert not o[n * t:].any()  # the padded rows' attention output is zero


def test_k3_sequences_do_not_see_their_neighbours():
    n, t, c = 12, 16, 64
    x, ws, bo, _, _ = _mha_inputs(n, t, c, 5, False)
    kw = dict(heads=1, scale=0.125, residual=False, eps=1e-5)
    ref, _ = k3_emulated(x, *ws, bo, None, None, **kw)
    loud = x.clone()
    loud[5] = 1e4 * loud[5]  # sequence 5 shares warpgroup rows with sequences 4, 6 and 7
    got, _ = k3_emulated(loud, *ws, bo, None, None, **kw)
    others = [i for i in range(n) if i != 5]
    assert torch.equal(got[others], ref[others])
    assert not torch.equal(got[5], ref[5])


# ---------------------------------------------------------------- the flagship sites


def _flagship_sites():
    """(K4 (rows, C), K3 (N, T, C, D)) of the CamContextI2V-256 UNet at full
    width for UNet batch 1 and 2 (batch 2: one CFG call of one request):
    every spatial and temporal transformer at the attention levels, the
    middle block, init_attn; 16 frames of 32 x 32 latents."""
    cfg = presets.camcontexti2v_256().unet
    frames, side = cfg.temporal_length, 256 // 8
    blocks = []  # (C of the blocks, hw)
    for level in range(len(cfg.channel_mult)):
        ds = 2 ** level
        if ds in cfg.attention_resolutions:
            blocks.append((cfg.model_channels * cfg.channel_mult[level], (side // ds) ** 2))
    ds_mid = 2 ** (len(cfg.channel_mult) - 1)
    blocks.append((cfg.model_channels * cfg.channel_mult[-1], (side // ds_mid) ** 2))
    ff, mha = set(), set()
    for b in (1, 2):
        for c, hw in blocks:
            _, d = cfg.heads_for(c)
            ff.add((b * frames * hw, c))
            mha.add((b * hw, frames, c, d))  # temporal self-attention
            if hw <= ta.MAX_T:
                mha.add((b * frames, hw, c, d))  # spatial self-attention over hw tokens
        if cfg.addition_attention:  # init_attn: 8 heads of num_head_channels at the first level
            c = 8 * cfg.num_head_channels
            ff.add((b * frames * side * side, c))
            mha.add((b * side * side, frames, c, cfg.num_head_channels))
    return sorted(ff), sorted(mha)


def test_kernels_take_every_flagship_site():
    ff, mha = _flagship_sites()
    assert {c for _, c in ff} == {320, 512, 640, 1280}
    for rows, c in ff:
        assert gff.supported(c, 4 * c, c), (rows, c)
    assert {t for _, t, _, _ in mha} == {16}
    for n, t, c, d in mha:
        assert ta.seq_ok(t) and ta.supported(t, c, c, d), (n, t, c, d)


def test_k3_sequence_rule_is_the_seams(monkeypatch):
    monkeypatch.setattr(ops, "route", lambda x, dtype=None, **kw: True)
    for t in range(1, 70):
        x = torch.empty(2, t, 64)
        assert nn_attention._fused_mha_ok(x, torch.bfloat16) == ta.seq_ok(t), t
        assert ta.seq_ok(t) == (t <= 32 and 64 % t == 0), t
        if ta.seq_ok(t):
            assert ta.supported(t, 64, 64, 64) and _gemm.BLOCK_M % t == 0


def test_wrappers_raise_on_shapes_the_kernels_do_not_take():
    """`_launch` (what a CUDA tensor reaches) checks before any launch and has
    no fallback to the twin."""
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="unsupported"):
        ta._launch(torch.zeros(4, 12, 64, dtype=bf), *[torch.zeros(64, 64)] * 4, torch.zeros(64), None, None,
                   heads=1, scale=0.125, residual=False, eps=1e-5)  # T = 12 does not divide 64
    with pytest.raises(ValueError, match="unsupported"):
        ta._launch(torch.zeros(4, 16, 64, dtype=bf), *[torch.zeros(64, 64)] * 4, torch.zeros(64), None, None,
                   heads=2, scale=0.125, residual=False, eps=1e-5)  # head dim 32
    c = 96  # not a whole number of 64-column k-stages
    with pytest.raises(ValueError, match="unsupported"):
        gff._launch(torch.zeros(8, c, dtype=bf), torch.ones(c), torch.zeros(c), torch.zeros(8 * c, c),
                    torch.zeros(8 * c), torch.zeros(c, 4 * c), torch.zeros(c), eps=1e-5)
