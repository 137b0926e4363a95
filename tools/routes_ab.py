"""K9 (two-phase GroupNorm) and K6p (epipolar attention on precomputed
penalties), the opt-in routes' kernels, on one GPU: each held against its
plain twin, then timed at the routes path's sites, optionally built from
another source directory or with extra nvcc flags, so that variants compare
in one call, one process each:

    python3 tools/routes_ab.py check         # every K9/K10/K6p case against the twins
    python3 tools/routes_ab.py time          # the sites' times of the tree's kernels
    python3 tools/routes_ab.py time --src DIR [-DNAME=VALUE ...]
                                             # the same, the two libraries built from DIR
    python3 tools/routes_ab.py time --blocks-per-sm N
                                             # K9's plan sized for N blocks per SM
    python3 tools/routes_ab.py unet          # the fused-CFG batch-2 CamContextI2V UNet call
                                             # with every route on: event time, host enqueue,
                                             # device time (all kernels; K6p's and K9's)

Copied into another checkout (e.g. the parent commit's, unpacked with git
archive) and run there, `time` and `unet` measure that checkout's kernels and
wrappers at the same sites, so two versions compare within one call.

`check` holds K9 and K10 at the 5-D UNet site (2, 16, 32, 32, 320) with and
without SiLU and at the VAE's 256x256 map viewed as (16, 16, 4096, 128)
with SiLU, K9 also at C = 128, 640 and 1280, T = 1 and 3, rows that leave a
ragged slice and f32; K9 twice on the same input must give the same bits.
K6p at small layouts (4 frames of 16x16 at ds 8, D = 32, 64, 128, no
registers, penalties per sample and shared, finite penalties that are not
0 / -1e30) and the flagship's ds8 and ds16 levels at batch 1 and 2 on the
bench trajectory. Every case within 4 bf16 ulps of the twin's max |value|
(as chip_smoke.py). `time` prints, per site, the CUDA-event time per call
over 50 launches, the host's enqueue time, the profiler's device time per
call by kernel, the library call (`F.group_norm` without SiLU; SDPA with the
penalties as a bf16 mask), K6 on the same inputs, and the bound (bytes over
3.35 TB/s). It also prints the registers, spills and shared memory nvcc
reported. Exit status 1 when a case disagrees.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from camc2v_tpu_torch.ops import epipolar_flash as ef  # noqa: E402
from camc2v_tpu_torch.ops import groupnorm as gn  # noqa: E402

import chip_smoke  # noqa: E402  (the bench trajectory's geometry)
import flash_ab  # noqa: E402  (build and comparison, shared with K2/K5's tool)
from epipolar_ab import small_F  # noqa: E402
from flash_ab import DEV, build, compare  # noqa: E402

NAMES = ("groupnorm_twophase", "epipolar_precomp", "epipolar_flash")
PEAK_BYTES = 3.35e12
ROUTE_SWITCHES = ("CAMC2V_EPI_PRECOMP", "CAMC2V_LN_FUSED", "CAMC2V_GN_TEMPORAL", "CAMC2V_GN_BIG4D",
                  "CAMC2V_FUSED_CFG")


def randn(*shape, scale=1.0, mean=0.0):
    return torch.randn(*shape, generator=flash_ab.G, device=DEV) * scale + mean


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(fn, reps=50, prof_reps=None):
    """(event ms, host enqueue ms, {kernel: (device ms, launches)} per call);
    the profile over `prof_reps` calls (default `reps`: a profile of many
    calls of a whole UNet loses kernels, so `unet` profiles one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    prof_reps = prof_reps or reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_reps):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dt = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            by[e.key] = (dt / 1e3 / prof_reps, e.count / prof_reps)
    return ms, host, by


def device_ms(by):
    return sum(ms for ms, _ in by.values())


# ------------------------------------------------------------------ K9, K10

GN_SITES = [("5-D ds1 (2,16,32,32,320)", (2, 16, 32, 32, 320)),
            ("VAE 256^2 view (16,16,4096,128)", (16, 16, 4096, 128))]
GN_CASES = [("5-D ds1 (2,16,32,32,320) silu", (2, 16, 32, 32, 320), True, torch.bfloat16),
            ("5-D ds1 (2,16,32,32,320)", (2, 16, 32, 32, 320), False, torch.bfloat16),
            ("VAE 256^2 view (16,16,4096,128) silu", (16, 16, 4096, 128), True, torch.bfloat16),
            ("ds2 (2,16,16,16,640) silu", (2, 16, 16, 16, 640), True, torch.bfloat16),
            ("ds8 (1,16,4,4,1280)", (1, 16, 4, 4, 1280), False, torch.bfloat16),
            ("T=1 (3,1,8,8,1280) silu", (3, 1, 8, 8, 1280), True, torch.bfloat16),
            ("T=3 ragged HW (2,3,7,9,320) silu", (2, 3, 7, 9, 320), True, torch.bfloat16),
            ("C=128 ragged (1,5,11,13,128)", (1, 5, 11, 13, 128), False, torch.bfloat16),
            ("f32 (2,16,16,16,320) silu", (2, 16, 16, 16, 320), True, torch.float32),
            ("f32 C=1280 (2,4,8,8,1280)", (2, 4, 8, 8, 1280), False, torch.float32)]


def gn_inputs(shape, dtype=torch.bfloat16):
    return (randn(*shape, scale=2.0, mean=0.5).to(dtype), randn(shape[-1], scale=0.2, mean=1.0),
            randn(shape[-1], scale=0.2))


@torch.no_grad()
def check_gn():
    for label, shape, silu, dtype in GN_CASES:
        x, s, b = gn_inputs(shape, dtype)
        twin = gn.group_norm_temporal_plain(x, s, b, silu=silu)
        got = gn.group_norm_fused_temporal(x, s, b, silu=silu)
        compare(f"K9 {label} {str(dtype)[6:]}", got, twin)
        if not torch.equal(got, gn.group_norm_fused_temporal(x, s, b, silu=silu)):
            flash_ab.FAILS.append(f"K9 {label}: two runs differ")
            print(f"  BAD K9 {label}: two runs differ", flush=True)
        if shape[-1] in (128, 320):
            compare(f"K10 {label} {str(dtype)[6:]}", gn.group_norm_fused_big(x, s, b, silu=silu), twin)


@torch.no_grad()
def time_gn():
    for label, shape in GN_SITES:
        x, s, b = gn_inputs(shape)
        xn = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2)  # (N, C, positions), the library's layout
        plan = gn.temporal_plan(shape[0], x[0].numel() // shape[-1], shape[-1], 2, torch.cuda.get_device_properties(
            DEV).multi_processor_count) if hasattr(gn, "temporal_plan") else "n/a"
        k9 = timed(lambda: gn.group_norm_fused_temporal(x, s, b, silu=True))
        k10 = timed(lambda: gn.group_norm_fused_big(x, s, b, silu=True))
        lib = timed(lambda: torch.nn.functional.group_norm(xn, 32, s.to(x.dtype), b.to(x.dtype), 1e-5), reps=20)
        bound = (2 * nbytes(x) + nbytes(s, b)) / PEAK_BYTES * 1e3
        print(f"  K9 {label} + SiLU, plan {plan}: {k9[0]:.4f} ms (host {k9[1]:.4f}, device {device_ms(k9[2]):.4f}: "
              f"{ {k[:60]: (round(v, 4), n) for k, (v, n) in k9[2].items()} }); K10 {k10[0]:.4f} ms (device "
              f"{device_ms(k10[2]):.4f}); F.group_norm {lib[0]:.4f} ms (device {device_ms(lib[2]):.4f}); bound "
              f"{bound:.4f} ms, reading x twice {1.5 * bound:.4f}", flush=True)


# ------------------------------------------------------------------ K6p

def pen_inputs(F, t, h, w, ds, heads, nreg, b, pb, d=64, finite=False):
    """q, k, v, lines (b of them from F's first pb batches, repeated), the
    kernels' tile map and (pb, Lq, t*hw) penalties; `finite` adds values in
    [-3, 1) to the visible pairs' 0."""
    lines_pb = ef.epipolar_lines(F[:pb], h, w, ds)
    lines = lines_pb.repeat(b // pb, 1, 1, 1)
    pen = ef.materialize_penalties(lines_pb, t, h, w, ds)
    if finite:
        pen = torch.where(pen == 0, (torch.rand(pen.shape, generator=flash_ab.G, device=DEV) * 4 - 3).to(pen.dtype),
                          pen)
    lq = lines.shape[1]
    q = randn(b, lq, heads, d).to(torch.bfloat16)
    k, v = (randn(b, t * h * w + nreg, heads, d).to(torch.bfloat16) for _ in range(2))
    kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
    return q, k, v, lines, ef.kernel_tile_map(lines, t, h, w, ds), pen, kw


def pen_case(name, F, t, h, w, ds, heads, nreg, b, pb, d=64, finite=False):
    q, k, v, lines, tiles, pen, kw = pen_inputs(F, t, h, w, ds, heads, nreg, b, pb, d, finite)
    with torch.no_grad():
        got = ef.epipolar_flash_attention(q, k, v, lines, block_k=ef.choose_block_k(h * w), tile_any=tiles,
                                          penalties=pen, **kw)
        ref = ef.epipolar_attention_precomp_plain(q, k, v, pen, t=t, h=h, w=w)
    compare(f"K6p {name}", got, ref)


def flagship(b):
    F = chip_smoke.bench_F(DEV, b=1)
    return [(f"ds8 B={b} pb=1 ({b},16384,5,64)", F, 16, 32, 32, 8, 5, 4, b, 1),
            (f"ds16 B={b} pb=1 ({b},4096,10,64)", F, 16, 16, 16, 16, 10, 4, b, 1)]


def check_pen():
    t, hw = 4, 16
    F2 = torch.cat([small_F(t, 128), small_F(t, 128, torch.eye(t, dtype=torch.bool, device=DEV))])
    for d in (32, 64, 128):
        pen_case(f"small D={d} (2,1024,2,{d}) pb=2", F2, t, hw, hw, 8, 2, 4, 2, 2, d=d)
    pen_case("small pb=1 shared (2,1024,2,64)", F2, t, hw, hw, 8, 2, 4, 2, 1)
    pen_case("small, no registers (2,1024,2,64)", F2, t, hw, hw, 8, 2, 0, 2, 2)
    pen_case("small, finite penalties (2,1024,2,64) pb=2", F2, t, hw, hw, 8, 2, 4, 2, 2, finite=True)
    pen_case("small, finite penalties (2,1024,2,64) pb=1", F2, t, hw, hw, 8, 2, 4, 2, 1, finite=True)
    for b in (1, 2):
        for site in flagship(b):
            pen_case(*site)


def time_pen():
    for name, F, t, h, w, ds, heads, nreg, b, pb in flagship(2):
        q, k, v, lines, tiles, pen, kw = pen_inputs(F, t, h, w, ds, heads, nreg, b, pb)
        bk = ef.choose_block_k(h * w)
        with torch.no_grad():
            k6p = timed(lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles,
                                                            penalties=pen, **kw))
            k6 = timed(lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles, **kw))
            mask = torch.cat([pen, torch.zeros(pb, pen.shape[1], nreg, dtype=pen.dtype, device=DEV)], dim=-1)[:, None]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa = timed(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=5)
        del mask
        pairs = ef.mask_pairs(lines, heads=heads, **kw)
        pen_bytes = ef.visible_penalty_bytes(tiles, t=t, hw=h * w, pb=pb, block_q=ef.KERNEL_BQ,
                                             block_k=ef.KERNEL_BK)
        by_bytes = (nbytes(q, k, v, q, tiles) + pen_bytes) / PEAK_BYTES * 1e3
        by_ops = 4 * 64 * pairs / 989e12 * 1e3
        print(f"  K6p {name}: {k6p[0]:.4f} ms (host {k6p[1]:.4f}, device {device_ms(k6p[2]):.4f}); K6 on the same "
              f"inputs {k6[0]:.4f} ms (device {device_ms(k6[2]):.4f}); SDPA with the bf16 mask {sdpa[0]:.4f} ms; "
              f"bound {max(by_bytes, by_ops):.4f} ms ({'bytes' if by_bytes >= by_ops else 'operations'}; penalty "
              f"tiles left on {pen_bytes / 2 ** 20:.1f} MiB)", flush=True)
        torch.cuda.empty_cache()


# ------------------------------------------------------------------ the fused routes UNet call

@torch.no_grad()
def fused_call(model):
    """The one batch-2 UNet call of a fused-CFG guided step of a batch-1
    request with the routes on (penalties shared, the uncond padded), as
    chip_smoke.py's phase 8 makes it."""
    from camc2v_tpu_torch.nn.epipolar import add_precomputed_penalties

    batch = chip_smoke.camcontext_batch(model, 1, 51, DEV)
    calls = []
    real = model.apply_model
    z, cond = model.prepare_batch(batch, prefetch_uncond=True)
    cond["camera"]["epi_prep"] = add_precomputed_penalties(cond["camera"]["epi_prep"], model.config.epipolar,
                                                           model.config.video_length)
    uc = model.build_uncond(cond, 1, (256, 256))
    cond.pop("_uncond", None)
    fn = model.build_guided_fn(cond, uc, model.get_fs(batch), guidance_scale=7.5, guidance_rescale=0.7)
    x = torch.randn(z.shape, generator=torch.Generator(device=DEV).manual_seed(52), device=DEV)
    model.apply_model = lambda *a, **k: calls.append(a) or real(*a, **k)
    try:
        fn(x, torch.full((1,), 999, device=DEV))
    finally:
        del model.apply_model
    return calls[0]


@torch.no_grad()
def unet():
    """The fused call with every route on, with K9 off (`CAMC2V_GN_TEMPORAL`
    = 0) and without the penalties (K6 in the UNet): event time over 10
    calls, host enqueue, and the device time of one profiled call, all
    kernels and K6p's, K6's and K9's."""
    from camc2v_tpu_torch import presets

    os.environ.update({k: "1" for k in ROUTE_SWITCHES})
    model = presets.build("camcontexti2v_256", seed=4321)
    x, t, c, fs = fused_call(model)
    prep = c["camera"]["epi_prep"]
    no_pen = dict(c, camera=dict(c["camera"], epi_prep={
        ds: {k: v for k, v in e.items() if k != "penalties"} for ds, e in prep.items()}))
    kernels = {"K6p": ("PenaltyMask", "epipolar_precomp_kernel"), "K6": ("LineMask",),
               "K9": ("gn_moments_kernel", "gn_apply_kernel", "gn_row_moments_kernel", "gn_apply_stats_kernel")}
    for label, cond, gn_temporal in (("all routes on", c, "1"), ("K9 off (CAMC2V_GN_TEMPORAL=0)", c, "0"),
                                     ("no penalties (K6 in the UNet)", no_pen, "1")):
        os.environ["CAMC2V_GN_TEMPORAL"] = gn_temporal
        step = lambda: model.apply_model(x, t, cond, fs)  # noqa: E731
        for _ in range(3):
            step()
        ms, host, by = timed(step, reps=10, prof_reps=1)
        parts = {name: round(sum(v for k, (v, _) in by.items() if any(n in k for n in names)), 3)
                 for name, names in kernels.items()}
        print(f"  routes fused-CFG UNet call (batch 2), {label}: {ms:.3f} ms (host enqueue {host:.3f} ms per call), "
              f"device time {device_ms(by):.3f} ms per call; {parts}", flush=True)
    os.environ["CAMC2V_GN_TEMPORAL"] = "1"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("check", "time", "unet"))
    ap.add_argument("--src", default=None, help="build the kernels from this source directory")
    ap.add_argument("--blocks-per-sm", type=int, default=None, help="K9's plan: blocks per SM")
    args, flags = ap.parse_known_args()
    if not torch.cuda.is_available():
        sys.exit("routes_ab.py: needs a CUDA card")
    if args.blocks_per_sm is not None:
        gn.K9_BLOCKS_PER_SM = args.blocks_per_sm
    flash_ab.G = torch.Generator(device=DEV).manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    build(args.src, flags, NAMES)
    if args.what == "check":
        check_gn()
        check_pen()
    elif args.what == "time":
        time_gn()
        time_pen()
    else:
        unet()
    print(f"disagreeing cases: {flash_ab.FAILS}", flush=True)
    sys.exit(1 if flash_ab.FAILS else 0)


if __name__ == "__main__":
    main()
