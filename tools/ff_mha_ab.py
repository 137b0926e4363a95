"""K4 (LayerNorm + GEGLU feed-forward) and K3 (temporal MHA) on one GPU: each
held against its plain twin, then timed at the flagship UNet's sites,
optionally built from another source directory or with extra nvcc flags, so
that tile and stage choices are measured in one call, one process each:

    python3 tools/ff_mha_ab.py check            # every K3/K4 case against the twins
    python3 tools/ff_mha_ab.py time             # per-site times of the tree's kernels
    python3 tools/ff_mha_ab.py time --src DIR [-DNAME=VALUE ...]
                                                # the same, the two libraries built from DIR
                                                # (e.g. -DGEGLU_STAGES=3 -DOUT_STAGES=3)
    python3 tools/ff_mha_ab.py time --max-splits 1
                                                # the wrappers' plan overridden: no split of K
    python3 tools/ff_mha_ab.py unet             # batch-1 CamContextI2V UNet calls: event time,
                                                # host enqueue, device time (all kernels; K3/K4's)

Copied into another checkout (e.g. the parent commit's, unpacked with git
archive) and run there, `time` and `unet` measure that checkout's kernels and
wrappers at the same sites, so two versions compare within one call.

`check` covers every full-width site of a batch-1 CamContextI2V UNet call
(K4 at C = 320, 512, 640, 1280; K3 with and without LayerNorm and residual)
and the batch-2 shapes of chip_smoke.py's phase 3, row counts that leave a
ragged last tile, K split in 2, 4 and 8 parts, both GEMM-1 tiles, and K3 at
T = 1, 2, 4, 8, 32 with N not a multiple of the sequences per tile (4 bf16
ulps of the twin's max |value|, as chip_smoke.py). `time` prints, per site,
the CUDA-event time per call over 50 launches, the host's enqueue time, the
profiler's device time by kernel (LayerNorm pass, GEMMs) and the bound
(operations over 989 TFLOP/s bf16 or bytes over 3.35 TB/s). It also prints
the registers and spills nvcc reported. Exit status 1 when a case
disagrees.
"""

import argparse
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flash_ab import build, event_ms  # noqa: E402  (tools/flash_ab.py)

from camc2v_tpu_torch.ops import geglu_ff as gff  # noqa: E402
from camc2v_tpu_torch.ops import temporal_attention as ta  # noqa: E402

try:
    from camc2v_tpu_torch.ops import _gemm  # noqa: E402
except ImportError:  # a checkout from before the GEMM core: no split of K to report
    _gemm = None

DEV = torch.device("cuda:0")
G = None  # the inputs' generator, seeded in main()
FAILS = []
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12

# the full-width sites of one batch-1 CamContextI2V UNet call (16 frames of
# 32 x 32 latents), then phase 3's batch-2 shapes: K4 (rows, C); K3 (N, T, C,
# heads, LayerNorm + residual)
FF_SITES = [(16384, 320), (16384, 512), (4096, 640), (1024, 1280), (256, 1280), (32768, 320), (2048, 1280)]
MHA_SITES = [(1024, 16, 320, 5, True), (1024, 16, 320, 5, False), (1024, 16, 512, 8, True),
             (256, 16, 640, 10, True), (256, 16, 640, 10, False), (64, 16, 1280, 20, True),
             (64, 16, 1280, 20, False), (16, 16, 1280, 20, True), (2048, 16, 320, 5, True),
             (128, 16, 1280, 20, True)]


def rn(*shape, scale=1.0):
    return (torch.randn(*shape, generator=G, device=DEV) * scale).to(torch.bfloat16)


def f32n(*shape, scale=1.0, mean=0.0):
    return torch.randn(*shape, generator=G, device=DEV) * scale + mean


def compare(name, got, ref):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    tol = 4 * 2.0 ** -8 * ref.abs().max().item()
    ok = err <= tol and bool(torch.isfinite(got).all())
    print(f"  {'ok ' if ok else 'BAD'} {name}: err {err:.3e} tol {tol:.3e}", flush=True)
    if not ok:
        FAILS.append(name)


def ff_args(rows, c):
    return (rn(rows, c), f32n(c, scale=0.2, mean=1.0), f32n(c, scale=0.2), rn(8 * c, c, scale=c ** -0.5),
            f32n(8 * c, scale=0.1), rn(c, 4 * c, scale=(4 * c) ** -0.5), f32n(c, scale=0.1))


def mha_args(n, t, c, ln):
    x = rn(n, t, c)
    w = [rn(c, c, scale=c ** -0.5) for _ in range(4)]
    kw = dict(ln_scale=f32n(c, scale=0.2, mean=1.0), ln_bias=f32n(c, scale=0.2), residual=True) if ln else {}
    return x, w, f32n(c, scale=0.1), kw


def mha_plain(x, w, bo, kw, heads):
    return ta.mha_plain(x, *w, bo, kw.get("ln_scale"), kw.get("ln_bias"), heads=heads, scale=64 ** -0.5,
                        residual=bool(kw))


@torch.no_grad()
def check():
    for rows, c in FF_SITES + [(1000, 320), (77, 640), (129, 64), (50, 512), (300, 192)]:
        args = ff_args(rows, c)
        compare(f"K4 ({rows}, {c})", gff._launch(*args, eps=1e-5), gff.ff_plain(*args, inner=4 * c, eps=1e-5))
    cases = [(n, t, c, h, ln) for n, t, c, h, ln in MHA_SITES]
    cases += [(37, 8, 320, 5, True), (5, 32, 640, 10, True), (300, 1, 64, 1, False), (75, 4, 128, 2, True),
              (33, 2, 192, 3, False), (9, 16, 320, 5, True)]
    for n, t, c, heads, ln in cases:
        x, w, bo, kw = mha_args(n, t, c, ln)
        got = ta._launch(x, *w, bo, kw.get("ln_scale"), kw.get("ln_bias"), heads=heads, scale=64 ** -0.5,
                         residual=bool(kw), eps=1e-5)
        compare(f"K3 ({n}, {t}, {c}) heads {heads}{' LN+res' if ln else ''}", got, mha_plain(x, w, bo, kw, heads))


def device_ms_by_kernel(fn, reps=10):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"ln_rows|Geglu|BiasResidual|QkvAttention|out_reduce|geglu_ff_kernel|temporal_mha_kernel",
                         e.key)
        if name:
            dt = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out[name.group(0)] = out.get(name.group(0), 0.0) + dt / 1e3 / reps
    return {k: round(v, 4) for k, v in out.items()}


def device_ms_total(fn, reps=3):
    """Device time per call of every kernel `fn` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return total / 1e3 / reps


def bound(nbytes, flops):
    return max(nbytes / PEAK_BYTES, flops / PEAK_BF16) * 1e3


def splits(rows, n, k):
    return "n/a" if _gemm is None else _gemm.out_splits(rows, n, k, _gemm.sm_count(DEV))


@torch.no_grad()
def timing():
    for rows, c in FF_SITES:
        args = ff_args(rows, c)
        fn = lambda: gff._launch(*args, eps=1e-5)  # noqa: E731
        ms, host = event_ms(fn)
        b = bound(4 * rows * c + 2 * 12 * c * c, 24 * rows * c * c)
        print(f"  K4 ({rows}, {c}) splits {splits(rows, c, 4 * c)}: {ms:.4f} ms (host {host:.4f}), bound {b:.4f} ms; "
              f"device by kernel {device_ms_by_kernel(fn)}", flush=True)
    for n, t, c, heads, ln in MHA_SITES:
        x, w, bo, kw = mha_args(n, t, c, ln)
        fn = lambda: ta._launch(x, *w, bo, kw.get("ln_scale"), kw.get("ln_bias"), heads=heads,  # noqa: E731
                                scale=0.125, residual=bool(kw), eps=1e-5)
        ms, host = event_ms(fn)
        rows = n * t
        b = bound(4 * rows * c + 8 * c * c, 8 * rows * c * c + 4 * rows * t * c)
        print(f"  K3 ({n}, {t}, {c}){' LN+res' if ln else ''} splits {splits(rows, c, c)}: {ms:.4f} ms "
              f"(host {host:.4f}), "
              f"bound {b:.4f} ms; "
              f"device by kernel {device_ms_by_kernel(fn)}", flush=True)


@torch.no_grad()
def unet():
    """Batch-1 CamContextI2V-256 UNet calls as chip_smoke.py's phase 4 makes
    them (seeded weights, bf16, the bench camera): event time over 10 calls,
    the host's enqueue time per call, and the profiler's device time per call
    of every kernel and of K3/K4's kernels."""
    import chip_smoke
    from camc2v_tpu_torch import presets

    model = presets.build("camcontexti2v_256", seed=4321)
    args = chip_smoke._unet_call_inputs(model, DEV)
    step = lambda: model.unet(*args)  # noqa: E731
    for _ in range(3):
        step()
    ms, host = event_ms(step, reps=10)
    print(f"  UNet call batch 1: {ms:.3f} ms (host enqueue {host:.3f} ms per call), device time "
          f"{device_ms_total(step):.3f} ms per call; K3/K4 kernels {device_ms_by_kernel(step, reps=3)}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("check", "time", "unet"))
    ap.add_argument("--src", default=None, help="build the two kernels from this source directory")
    ap.add_argument("--max-splits", type=int, default=None, help="the most parts the out GEMM's K is split into")
    args, flags = ap.parse_known_args()
    if args.max_splits is not None:
        _gemm.MAX_SPLITS = args.max_splits
    if not torch.cuda.is_available():
        sys.exit("ff_mha_ab.py: needs a CUDA card")
    global G
    G = torch.Generator(device=DEV).manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    build(args.src, flags, names=("geglu_ff", "temporal_attention"))
    {"check": check, "time": timing, "unet": unet}[args.what]()
    print(f"disagreeing cases: {FAILS}", flush=True)
    sys.exit(1 if FAILS else 0)


if __name__ == "__main__":
    main()
