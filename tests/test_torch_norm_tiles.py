"""What surrounds the Hopper K1 (two-pass GroupNorm + SiLU) and K8's row
LayerNorm (also K3/K4's LN pass) on the CPU.

The kernels run only on the card (`chip_smoke.py` and `tools/norm_ab.py`
hold them against their plain twins there); these tests hold what the CPU
can reach, with the kernels' loops written out in PyTorch:

  * K1's plan (`ops/groupnorm.py::norm_plan`, which the wrapper launches
    with), over a sweep of (N, rows, C, dtype, SM count) that holds every
    GroupNorm site of the model: every row of every sample falls in exactly
    one block's slice and one thread's row group, the threads cover a row's
    16-byte pieces, a block's shared memory stays under 227 KB (and leaves
    two blocks an SM on the two-launch path), the cluster size or slices
    are the plan's rule's and follow from a sample's shape alone (the same
    plan at any batch size, so a sample's bits do not depend on its batch),
    and the path is the one the sizes give (one launch at every 4-D UNet site and the 5-D ds8
    level, two at the larger 5-D levels and the VAE's large maps);
    the plan's constants are the sources';
  * K1's arithmetic: each slice's local two-pass (per-thread sums over its
    rows, the fold of row groups and channels into groups by a warp's lanes
    and a shuffle tree, the slice's group means, the squared deviations),
    the fixed-order Chan merge of the slices (warps over slices, lanes over
    groups, the warps in order) and the apply, equal the JAX
    `group_norm_fused` (the Pallas kernel in interpret mode) on both paths,
    SiLU on and off, f32 and bf16; and a map of mean 100, std 0.1, where a
    single-pass variance fails;
  * K8's lane partition (`ops/layernorm.py::ln_plan`, the partition of
    `csrc/layernorm.cuh`): each element of a row in exactly one lane's
    pieces at C = 320, 640, 1280 (K3/K4's C_in) and the CLIP widths; and
    the row kernel's arithmetic (lane sums, shuffle tree, two passes from
    registers) against the JAX `layer_norm_fused` (interpret mode).

Inputs come from numpy with a seed. Tolerances, relative to the reference's
max |value|: 1e-5 in f32 (two f32 algorithms summing in another order), 4
bf16 ulps (4 * 2^-8) for bf16 outputs.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camc2v_tpu.ops import groupnorm as jgn
from camc2v_tpu.ops import layernorm as jln

from camc2v_tpu_torch.ops import groupnorm as gn
from camc2v_tpu_torch.ops import layernorm as ln

CSRC = Path(gn.__file__).resolve().parent.parent / "csrc"
ULP = 2.0 ** -8
SM_SMEM = 233472  # an H100 SM's shared memory (228 KB); 1 KB of it reserved per block


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these small tensors: parallel test workers
    share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(1e-6, float(np.abs(ref).max())), err_msg=what)


def _constants(path, names):
    text = (CSRC / path).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", text)
            if m.group(1) in names}


# ------------------------------------------------------------------ K1's plan

# (N, rows, C, bytes per element, SM count, path): the UNet's 4-D sites per
# frame at batch 1 (N = 16) and with CFG batched (N = 32), its 5-D temporal
# sites at batch 1 and 2, the VAE decoder's maps, f32, ragged maps, other cards
K1_SWEEP = [(n, h * h, c, 2, 132, "cluster") for n in (16, 32) for h, c in ((32, 320), (16, 640), (8, 1280), (4, 1280))]
K1_SWEEP += [(b, 16 * h * h, c, 2, 132, "two") for b in (1, 2) for h, c in ((32, 320), (16, 640), (8, 1280))]
K1_SWEEP += [(b, 16 * 16, 1280, 2, 132, "cluster") for b in (1, 2)]
K1_SWEEP += [(16, 256 * 256, 128, 2, 132, "two"), (16, 128 * 128, 256, 2, 132, "two"), (16, 64 * 64, 512, 2, 132, "two"),
             (16, 32 * 32, 512, 2, 132, "cluster"), (16, 1024, 320, 4, 132, "cluster"), (2, 4096, 640, 4, 132, "two"),
             (3, 63, 320, 2, 132, "cluster"), (1, 5 * 31 * 33, 640, 2, 108, "two"), (4, 1600, 128, 2, 78, "cluster"),
             (8, 1, 1280, 2, 132, "cluster"), (64, 1024, 320, 2, 132, "cluster")]


@pytest.mark.parametrize("n,rows,c,elem,sms,path", K1_SWEEP, ids=[str(p[:5]) for p in K1_SWEEP])
def test_k1_plan_covers_every_row_once(n, rows, c, elem, sms, path):
    plan = gn.norm_plan(n, rows, c, elem, 32, sms)
    assert plan.cluster == (path == "cluster")
    assert plan.pieces * gn.K9_PIECE_BYTES == c * elem
    threads = plan.pieces * plan.rgroups
    assert 32 <= threads <= gn.K1_THREADS and threads + plan.pieces > gn.K1_THREADS  # the most row groups that fit
    # every row of a sample in exactly one (slice, row group)
    hits = np.zeros(rows, np.int64)
    for si in range(plan.slices):
        r0, r1 = gn.slice_rows(rows, plan.slices, si)
        assert r0 < r1 or rows < plan.slices
        for rg in range(plan.rgroups):
            hits[r0 + rg:r1:plan.rgroups] += 1
    assert (hits == 1).all()
    # shared memory: the largest slice's block, under 227 KB with the static part
    assert plan.smem == gn.k1_smem(-(-rows // plan.slices), c, elem, plan.rgroups, 32)
    assert plan.smem + gn.K1_STATIC_SMEM <= gn.K1_SMEM_MAX
    # a sample's slices follow from its shape alone: the same bits alone and inside any batch
    for other in (1, 4, 2 * n + 1):
        assert gn.norm_plan(other, rows, c, elem, 32, sms)[:5] == plan[:5]
    if plan.cluster:
        # the fewest blocks (at least K1_MIN_SLICES) that let two share an SM, else the fewest that fit
        assert plan.slices <= gn.K1_MAX_CLUSTER and plan.apply is None
        sizes = range(min(gn.K1_MIN_SLICES, rows), min(gn.K1_MAX_CLUSTER, rows) + 1)
        fits = [k for k in sizes if gn.k1_smem(-(-rows // k), c, elem, plan.rgroups, 32) + gn.K1_STATIC_SMEM
                <= gn.K1_SMEM_MAX]
        two = [k for k in fits if gn.k1_smem(-(-rows // k), c, elem, plan.rgroups, 32) <= gn.K1_BLOCK_SMEM]
        assert plan.slices == (two or fits)[0]
    else:
        # two blocks an SM; as few slices as the shared memory allows, and at least half the SMs' worth
        assert 2 * (plan.smem + gn.K1_STATIC_SMEM + 1024) <= SM_SMEM
        assert plan.apply == gn.temporal_plan(n, rows, c, elem, sms)
        fewest = max(-(-rows // ((gn.K1_BLOCK_SMEM - gn.k1_smem(0, c, elem, plan.rgroups, 32)) // (c * elem))),
                     -(-sms // 2))
        assert plan.slices == min(rows, fewest)


def test_k1_plan_constants_are_the_sources():
    k1 = _constants("groupnorm.cu", {"THREADS_MAX", "CHUNKS", "MAX_CLUSTER", "SMEM_MAX", "STATIC_SMEM"})
    assert k1 == {"THREADS_MAX": gn.K1_THREADS, "CHUNKS": gn.K1_CHUNKS, "MAX_CLUSTER": gn.K1_MAX_CLUSTER,
                  "SMEM_MAX": gn.K1_SMEM_MAX, "STATIC_SMEM": gn.K1_STATIC_SMEM}
    assert _constants("gn_pieces.cuh", {"K9_UNROLL"}) == {"K9_UNROLL": gn.K9_UNROLL}
    text = (CSRC / "groupnorm.cu").read_text()
    # the layout k1_smem mirrors, term by term
    for term in ("l.red = (int)(max_rows * c * elem);", "l.part = l.red + rgroups * c * (int)sizeof(float);",
                 "l.xchg = l.part + p.vals * (int)sizeof(float);",
                 "l.gstat = l.xchg + MAX_CLUSTER * p.vals * (int)sizeof(float);",
                 "l.bars = (l.gstat + 2 * groups * (int)sizeof(float) + 7) / 8 * 8;",
                 "l.total = l.bars + CHUNKS * (int)sizeof(uint64_t);", "return 3 * groups + 1;"):
        assert term in text, term


@pytest.mark.parametrize("c,elem,groups", [(100, 2, 4), (6, 4, 2), (8200, 2, 40), (320, 2, 64)],
                         ids=["C=100 bf16", "C=6 f32", "C=8200 bf16", "64 groups"])
def test_k1_plan_refuses_what_the_kernels_do_not_take(c, elem, groups):
    with pytest.raises(ValueError, match="16-byte pieces|groups"):
        gn.norm_plan(1, 64, c, elem, groups, 132)


# ------------------------------------------------------------------ K1's arithmetic

def _butterfly(v, width=32):
    """An xor shuffle tree over `width` lanes (dim 0; common.cuh `warp_sum`,
    layernorm.cuh `row_sum`): lane 0's total."""
    idx = torch.arange(v.shape[0])
    o = width // 2
    while o:
        v = v + v[idx ^ o]
        o //= 2
    return v[0]


@functools.lru_cache(maxsize=None)
def _lane_shares(rgroups, cg):
    """(32, rgroups * cg) 0/1: lane l's share of a group's (row group,
    channel) values in csrc `fold_groups` (`thread_consts`)."""
    m = torch.zeros(32, rgroups, cg)
    for lane in range(32):
        if cg <= 32:
            rstep = 32 // cg
            if lane < rstep * cg:
                m[lane, lane // cg::rstep, lane % cg] = 1
        else:
            m[lane, :, lane::32] = 1
    assert (m.sum(0) == 1).all()  # every value in exactly one lane's share
    return m.reshape(32, -1)


def _fold(red, rgroups, c, groups):
    """csrc `fold_groups`: red (rgroups, C) -> (G,): each lane's share of a
    group's (row group, channel) values, then the shuffle tree."""
    cg = c // groups
    values = red.reshape(rgroups, groups, cg).permute(0, 2, 1).reshape(rgroups * cg, groups)
    return _butterfly(_lane_shares(rgroups, cg) @ values)


def _row_group_sums(v, rgroups):
    """(rows, C) -> (rgroups, C): row group rg's sum over rows rg, rg + rgroups, ..."""
    pad = -v.shape[0] % rgroups
    return torch.cat([v, v.new_zeros(pad, v.shape[1])]).reshape(-1, rgroups, v.shape[1]).sum(0)


def k1_emulated(x, scale, bias, plan, *, groups, eps, silu):
    """K1 in PyTorch, f32, over x (N, rows, C) on `plan`: each slice's local
    two-pass, the merge of the slices (warps over slices, lanes over groups,
    the warps in order), then the apply."""
    n, rows, c = x.shape
    cg = c // groups
    xf = x.float()
    nwarps = plan.pieces * plan.rgroups // 32
    y = torch.empty_like(xf)
    for b in range(n):
        parts = []
        for si in range(plan.slices):
            r0, r1 = gn.slice_rows(rows, plan.slices, si)
            xs = xf[b, r0:r1]
            s = _fold(_row_group_sums(xs, plan.rgroups), plan.rgroups, c, groups)
            mean_l = s / float((r1 - r0) * cg)
            d = xs - mean_l.repeat_interleave(cg)
            m2 = _fold(_row_group_sums(d * d, plan.rgroups), plan.rgroups, c, groups)
            parts.append((s, m2, mean_l, float(r1 - r0)))
        total = float(rows * cg)
        acc = [torch.zeros(groups) for _ in range(nwarps)]
        for k, (s, _, _, _) in enumerate(parts):
            acc[k % nwarps] = acc[k % nwarps] + s
        mean = sum(acc[1:], acc[0]) / total
        acc = [torch.zeros(groups) for _ in range(nwarps)]
        for k, (_, m2, mean_l, cnt) in enumerate(parts):
            acc[k % nwarps] = acc[k % nwarps] + (m2 + cnt * cg * (mean_l - mean) ** 2)
        inv = torch.rsqrt(sum(acc[1:], acc[0]) / total + eps)
        a = (xf[b] - mean.repeat_interleave(cg)) * inv.repeat_interleave(cg) * scale + bias
        y[b] = a / (1 + torch.exp(-a)) if silu else a
    return y.to(x.dtype)


def _two_launch_plan(n, rows, c, elem, slices):
    """A two-launch plan at a size the CPU reference runs quickly (the model
    takes this path only for samples over ~0.8 MB)."""
    p = gn.norm_plan(n, rows, c, elem, 32, 132)
    return p._replace(cluster=False, slices=slices, smem=gn.k1_smem(-(-rows // slices), c, elem, p.rgroups, 32),
                      apply=gn.temporal_plan(n, rows, c, elem, 132))


# (label, (N, H, W, C), plan maker): the cluster path as planned (pieces straddling groups of 10 channels;
# groups of 40, wider than a warp), and two launches on many slices (groups of 4, two in a piece)
K1_CASES = [("cluster C=320", (3, 9, 7, 320), lambda n, r, c, e: gn.norm_plan(n, r, c, e, 32, 132)),
            ("cluster C=1280", (2, 3, 5, 1280), lambda n, r, c, e: gn.norm_plan(n, r, c, e, 32, 132)),
            ("two launches C=128", (1, 12, 11, 128), lambda n, r, c, e: _two_launch_plan(n, r, c, e, 23))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("silu", [False, True], ids=["no silu", "silu"])
@pytest.mark.parametrize("label,shape,make", K1_CASES, ids=[c[0] for c in K1_CASES])
def test_k1_kernel_loops_match_pallas_interpret(label, shape, make, silu, dtype):
    rng = np.random.default_rng(len(label) + 2 * int(silu))
    x = (rng.standard_normal(shape) * 2.0 + 0.7).astype(np.float32)
    c = shape[-1]
    s, b = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    ref = np.asarray(jgn.group_norm_fused(jx, jnp.asarray(s), jnp.asarray(b), num_groups=32, eps=1e-5,
                                          silu=silu).astype(jnp.float32))
    n, rows = shape[0], shape[1] * shape[2]
    plan = make(n, rows, c, tx.element_size())
    assert plan.cluster == label.startswith("cluster") and plan.slices > 1
    got = k1_emulated(tx.reshape(n, rows, c), torch.from_numpy(s), torch.from_numpy(b), plan, groups=32, eps=1e-5,
                      silu=silu)
    _close(got.float().reshape(shape).numpy(), ref, 1e-5 if dtype == "f32" else 4 * ULP, f"{label} {dtype}")


def test_k1_merge_keeps_two_pass_accuracy_at_a_large_mean():
    """mean 100, std 0.1, f32, on a grid of 2^-6 with a group count of 256
    (every sum of x and each mean exact, so the result's error is the
    variance's alone): the slices' two-pass statistics merged by Chan's
    formula hold the reference within 1e-5, where a single-pass variance
    (E[x^2] - E[x]^2 in f32) is off by far more."""
    rng = np.random.default_rng(5)
    shape = (2, 8, 8, 128)
    x = (100.0 + np.round(6.4 * rng.standard_normal(shape)) / 64).astype(np.float32)
    s, b = np.ones(128, np.float32), np.zeros(128, np.float32)
    ref = np.asarray(jgn.group_norm_fused(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), num_groups=32, eps=1e-5))
    tx = torch.from_numpy(x).reshape(2, 64, 128)
    got = k1_emulated(tx, torch.from_numpy(s), torch.from_numpy(b), _two_launch_plan(2, 64, 128, 4, 7), groups=32,
                      eps=1e-5, silu=False)
    _close(got.reshape(shape).numpy(), ref, 1e-5, "two-pass merge at mean 100")
    g = tx.reshape(2, 64, 32, 4).permute(0, 2, 1, 3).reshape(2, 32, -1)
    single = torch.clamp((g * g).mean(-1) - g.mean(-1) ** 2, min=0.0)
    exact = g.double().var(-1, unbiased=False)
    assert ((single.double() - exact).abs() / exact).max() > 1e-2


# ------------------------------------------------------------------ K8's row partition

@pytest.mark.parametrize("c,elem", [(320, 2), (640, 2), (1280, 2), (1024, 2), (128, 2), (320, 4), (1280, 4), (4096, 2)],
                         ids=lambda v: str(v))
def test_k8_lanes_cover_each_element_once(c, elem):
    plan = ln.ln_plan(c, elem)
    assert plan.pieces * ln.LN_PIECE_BYTES == c * elem and 32 % plan.lanes == 0
    assert plan.per_lane <= ln.LN_MAX_PER_LANE and (plan.lanes == 32 or plan.per_lane <= ln.LN_TARGET_PER_LANE)
    assert plan.lanes == 1 or -(-plan.pieces // (plan.lanes // 2)) > ln.LN_TARGET_PER_LANE  # the fewest lanes
    vec = ln.LN_PIECE_BYTES // elem
    hits = np.zeros(c, np.int64)
    for lane in range(plan.lanes):
        for j in range(plan.per_lane):
            p = j * plan.lanes + lane
            if p < plan.pieces:
                hits[p * vec:(p + 1) * vec] += 1
    assert (hits == 1).all()
    if c in (320, 640, 1280):  # the UNet widths: no idle lane
        assert plan.pieces == plan.lanes * plan.per_lane


def test_k8_constants_are_the_header():
    consts = _constants("layernorm.cuh", {"THREADS", "TARGET_PER_LANE", "MAX_PER_LANE"})
    assert consts == {"THREADS": ln.LN_THREADS, "TARGET_PER_LANE": ln.LN_TARGET_PER_LANE,
                      "MAX_PER_LANE": ln.LN_MAX_PER_LANE}
    with pytest.raises(ValueError, match="16-byte pieces"):
        ln.ln_plan(100, 2)
    with pytest.raises(ValueError, match="16-byte pieces"):
        ln.ln_plan(8192, 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("c", [320, 1280])
def test_k8_row_loops_match_pallas_interpret(c, dtype):
    """The row kernel in PyTorch: a lane's pieces summed, the row's lanes by
    a shuffle tree, the mean; the squared deviations the same way, from the
    registers; the apply."""
    rng = np.random.default_rng(c)
    rows = 24
    x = (1.5 * rng.standard_normal((rows, c)) + 0.3).astype(np.float32)
    s, b = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32), (0.2 * rng.standard_normal(c)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    ref = np.asarray(jln.layer_norm_fused(jx, jnp.asarray(s), jnp.asarray(b), eps=1e-5).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32)))
    plan = ln.ln_plan(c, 2 if dtype == "bf16" else 4)
    vec = c // plan.pieces
    pieces = tx.reshape(rows, plan.pieces, vec)
    lanes = torch.zeros(plan.lanes, rows)
    for lane in range(plan.lanes):
        own = [j * plan.lanes + lane for j in range(plan.per_lane) if j * plan.lanes + lane < plan.pieces]
        lanes[lane] = pieces[:, own].sum((1, 2))
    mean = _butterfly(lanes, plan.lanes) / c
    d = tx - mean[:, None]
    for lane in range(plan.lanes):
        own = [j * plan.lanes + lane for j in range(plan.per_lane) if j * plan.lanes + lane < plan.pieces]
        lanes[lane] = (d.reshape(rows, plan.pieces, vec)[:, own] ** 2).sum((1, 2))
    inv = torch.rsqrt(_butterfly(lanes, plan.lanes) / c + 1e-5)
    got = d * inv[:, None] * torch.from_numpy(s) + torch.from_numpy(b)
    if dtype == "bf16":
        got = got.to(torch.bfloat16).float()
    _close(got.numpy(), ref, 1e-5 if dtype == "f32" else 4 * ULP, f"K8 C={c} {dtype}")
