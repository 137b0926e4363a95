"""K1 (two-pass GroupNorm + SiLU) and K8 (row LayerNorm, also K3/K4's LN
pass) on one GPU: each held against its plain twin, then timed at the
model's sites, so that two checkouts compare in one call, one process each:

    python3 tools/norm_ab.py check     # K1 and K8 against their twins, K1 twice for the same bits
    python3 tools/norm_ab.py time      # per site: events, host enqueue, device time by kernel
    python3 tools/norm_ab.py time --src DIR [-DNAME=VALUE ...] [--sites REGEX]
                                       # the same, the libraries built from DIR, at the sites matched
    python3 tools/norm_ab.py unet      # one batch-1 CamContextI2V UNet call: event time, host
                                       # enqueue, device time, K1's and K3 + K4's device time

Copied into another checkout (e.g. the parent commit's, unpacked with git
archive) and run there, `time` and `unet` measure that checkout's kernels and
wrappers at the same sites and on the same seeded inputs.

`check` holds K1 at every GroupNorm site of the UNet (4-D per frame at
batch 1 and with CFG batched, 5-D temporal at batch 1 and 2, every level),
the VAE's maps, f32, rows and channels that leave ragged slices or pieces
straddling two groups, and a map of mean 100 and std 0.1, SiLU on and off;
K8 at the UNet's, the CLIP towers' and other widths, bf16 and f32, ragged
rows. Every case within 4 bf16 ulps of the twin's max |value| (as
chip_smoke.py). `time` prints, per site, the CUDA-event time per call over
50 launches, the host's enqueue time, the profiler's device time per call
by kernel and the kernels per call, the library call (`F.group_norm`
without SiLU, `F.layer_norm`) and the bound (bytes over 3.35 TB/s); with the
K1 plan and the most clusters the card runs at once where the checkout has
them. Exit status 1 when a case disagrees.
"""

import argparse
import ctypes
import os
import re
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from camc2v_tpu_torch.ops import _build  # noqa: E402
from camc2v_tpu_torch.ops import groupnorm as gn  # noqa: E402
from camc2v_tpu_torch.ops import layernorm as ln  # noqa: E402

import chip_smoke  # noqa: E402  (the bench camera payload)
import flash_ab  # noqa: E402  (build and comparison, shared with K2/K5's tool)
from flash_ab import DEV, build, compare  # noqa: E402

NAMES = ("groupnorm", "layernorm", "groupnorm_twophase")
PEAK_BYTES = 3.35e12
SITES = ""  # the sites `time` measures: a regex on their labels
K1_KERNELS = re.compile(r"\bgn_(stats|apply|cluster_kernel|stats_kernel|norm_apply_kernel)<")

# (label, shape, eps): every GroupNorm site of a batch-1 CamContextI2V UNet
# call (4-D per frame, N = 16; 5-D temporal, N = 1), the same with CFG
# batched (N = 32, N = 2), and the VAE decoder's maps
GN_SITES = [(f"4-D ds{d} N={n}", (n, h, h, c), 1e-5)
            for n in (16, 32) for d, h, c in ((1, 32, 320), (2, 16, 640), (4, 8, 1280), (8, 4, 1280))]
GN_SITES += [(f"5-D ds{d} B={b}", (b, 16, h, h, c), 1e-6)
             for b in (1, 2) for d, h, c in ((1, 32, 320), (2, 16, 640), (4, 8, 1280), (8, 4, 1280))]
GN_SITES += [("VAE 256^2 (16,256,256,128)", (16, 256, 256, 128), 1e-6),
             ("VAE 64^2 (16,64,64,512)", (16, 64, 64, 512), 1e-6)]
GN_EXTRA = [("f32 4-D (16,32,32,320)", (16, 32, 32, 320), torch.float32),
            ("f32 5-D (2,16,16,16,640)", (2, 16, 16, 16, 640), torch.float32),
            ("ragged rows (3,7,9,320)", (3, 7, 9, 320), torch.bfloat16),
            ("ragged 5-D (1,5,31,33,640)", (1, 5, 31, 33, 640), torch.bfloat16),
            ("C=128 cg=4 (4,40,40,128)", (4, 40, 40, 128), torch.bfloat16),
            ("C=256 (2,24,24,256)", (2, 24, 24, 256), torch.bfloat16),
            ("one row (8,1,1,1280)", (8, 1, 1, 1280), torch.bfloat16)]
LN_SITES = [("UNet ds1 (32768, 320)", (32768, 320)), ("UNet ds2 (8192, 640)", (8192, 640)),
            ("UNet ds4 (2048, 1280)", (2048, 1280)), ("CLIP vision (1028, 1280)", (1028, 1280)),
            ("CLIP text (154, 1024)", (154, 1024))]


def randn(*shape, scale=1.0, mean=0.0):
    return torch.randn(*shape, generator=flash_ab.G, device=DEV) * scale + mean


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def timed(fn, reps=50, prof_reps=None):
    """(event ms, host enqueue ms, {kernel: (device ms, launches)} per call)."""
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
            name = re.sub(r"\(anonymous namespace\)::|\(.*$", "", e.key)
            ms_, n_ = by.get(name, (0.0, 0.0))
            by[name] = (ms_ + dt / 1e3 / prof_reps, n_ + e.count / prof_reps)
    return ms, host, by


def device_ms(by, pattern=None):
    return sum(ms for k, (ms, _) in by.items() if pattern is None or re.search(pattern, k))


def gn_inputs(shape, dtype=torch.bfloat16, scale=2.0, mean=0.5):
    return (randn(*shape, scale=scale, mean=mean).to(dtype), randn(shape[-1], scale=0.2, mean=1.0),
            randn(shape[-1], scale=0.2))


def k1_plan(x):
    """The checkout's K1 plan for x and the most clusters the card runs at
    once for it (or 'n/a' where the checkout has no plan)."""
    if not hasattr(gn, "norm_plan"):
        return "n/a"
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    plan = gn.norm_plan(n, rows, c, x.element_size(), 32, torch.cuda.get_device_properties(DEV).multi_processor_count)
    out = f"{'cluster' if plan.cluster else 'two launches'} slices={plan.slices} rgroups={plan.rgroups} smem={plan.smem}"
    if plan.cluster:
        fn = _build.function("groupnorm", "gn_max_active_clusters", [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 5)
        out += f" clusters={n} max_active={fn(n, rows, c, 32, plan.slices, plan.rgroups, int(x.element_size() == 2))}"
    return out


@torch.no_grad()
def check():
    cases = [(label, shape, eps, torch.bfloat16) for label, shape, eps in GN_SITES]
    cases += [(label, shape, 1e-5, dtype) for label, shape, dtype in GN_EXTRA]
    for label, shape, eps, dtype in cases:
        for silu in (True, False):
            x, s, b = gn_inputs(shape, dtype)
            kw = dict(num_groups=32, eps=eps, silu=silu)
            got = gn.group_norm_fused(x, s, b, **kw)
            compare(f"K1 {label} {str(dtype)[6:]} silu={silu} [{k1_plan(x)}]", got, gn.group_norm_plain(x, s, b, **kw))
            if not torch.equal(got, gn.group_norm_fused(x, s, b, **kw)):
                flash_ab.FAILS.append(f"K1 {label}: two runs differ")
                print(f"  BAD K1 {label}: two runs differ", flush=True)
    for shape in ((16, 32, 32, 320), (1, 16, 32, 32, 320)):  # mean 100, std 0.1: a single-pass variance fails here
        x, s, b = gn_inputs(shape, scale=0.1, mean=100.0)
        compare(f"K1 offset mean 100 std 0.1 {shape}", gn.group_norm_fused(x, s, b, silu=True),
                gn.group_norm_plain(x, s, b, silu=True))
    for label, shape in LN_SITES + [("ragged rows (1001, 320)", (1001, 320)), ("C=128 (77, 128)", (77, 128)),
                                    ("C=4096 (33, 4096)", (33, 4096))]:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and shape[-1] > 2048:
                continue
            x = randn(*shape, scale=1.5, mean=0.3).to(dtype)
            s, b = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
            compare(f"K8 {label} {str(dtype)[6:]}", ln.layer_norm_fused(x, s, b), ln.layer_norm_plain(x, s, b))


@torch.no_grad()
def time_sites():
    total = 0.0
    for label, shape, eps in GN_SITES:
        if not re.search(SITES, label):
            continue
        x, s, b = gn_inputs(shape)
        xn = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2)  # (N, C, positions), the library's layout
        k1 = timed(lambda: gn.group_norm_fused(x, s, b, eps=eps, silu=True))
        lib = timed(lambda: torch.nn.functional.group_norm(xn, 32, s.to(x.dtype), b.to(x.dtype), eps), reps=20)
        bound = (2 * nbytes(x) + nbytes(s, b)) / PEAK_BYTES * 1e3
        dev = device_ms(k1[2])
        total += dev
        kernels = {k[:48]: (round(v, 4), n) for k, (v, n) in k1[2].items()}
        print(f"  K1 {label} + SiLU [{k1_plan(x)}]: {k1[0]:.4f} ms (host {k1[1]:.4f}, device {dev:.4f}: {kernels}); "
              f"F.group_norm {lib[0]:.4f} ms (device {device_ms(lib[2]):.4f}); bound {bound:.4f} ms", flush=True)
    print(f"  K1 device time summed over the sites: {total:.4f} ms", flush=True)
    for label, shape in LN_SITES:
        if not re.search(SITES, label):
            continue
        x = randn(*shape, scale=1.5, mean=0.3).to(torch.bfloat16)
        s, b = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        k8 = timed(lambda: ln.layer_norm_fused(x, s, b))
        lib = timed(lambda: torch.nn.functional.layer_norm(x, (shape[-1],), s.to(x.dtype), b.to(x.dtype), 1e-5),
                    reps=20)
        bound = (2 * nbytes(x) + nbytes(s, b)) / PEAK_BYTES * 1e3
        print(f"  K8 {label}: {k8[0]:.4f} ms (host {k8[1]:.4f}, device {device_ms(k8[2]):.4f}); F.layer_norm "
              f"{lib[0]:.4f} ms (device {device_ms(lib[2]):.4f}); bound {bound:.4f} ms", flush=True)


@torch.no_grad()
def unet():
    """A batch-1 CamContextI2V-256 UNet call on the bench camera payload
    (the default path, the switches off): event time over 10 calls, host
    enqueue per call, and the device time of one profiled call, in all and
    by K1, by K3 + K4 (GEMM core and LN pass) and by the row LN pass."""
    from camc2v_tpu_torch import presets

    model = presets.build("camcontexti2v_256", seed=4321)
    g = torch.Generator(device=DEV).manual_seed(8)
    cfg = model.config.unet
    cam = model.camera_condition(chip_smoke.camcontext_batch(model, 1, 9, DEV),
                                 torch.zeros(1, dtype=torch.long, device=DEV))
    x = torch.randn(1, 16, 32, 32, 8, generator=g, device=DEV)
    ctx = torch.randn(1, 77 + 3 * 256, cfg.context_dim, generator=g, device=DEV)
    t, fs = torch.tensor([999], device=DEV), torch.tensor([3], device=DEV)
    step = lambda: model.unet(x, t, ctx, fs, cam)  # noqa: E731
    for _ in range(3):
        step()
    for _ in range(2):
        ms, host, by = timed(step, reps=10, prof_reps=1)
        k1 = {k: (round(v, 3), n) for k, (v, n) in by.items() if K1_KERNELS.search(k)}
        print(f"  CamContextI2V UNet call batch 1: {ms:.3f} ms (host enqueue {host:.3f} ms per call), device "
              f"{device_ms(by):.3f} ms; K1 {sum(v for v, _ in k1.values()):.3f} ms {k1}; K3 + K4 "
              f"{device_ms(by, r'gemm_kernel|ln_rows|out_reduce'):.3f} ms (row LN pass {device_ms(by, 'ln_rows'):.3f})",
              flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("check", "time", "unet"))
    ap.add_argument("--src", default=None, help="build the kernels from this source directory")
    ap.add_argument("--sites", default="", help="time only the sites whose label matches this regex")
    args, flags = ap.parse_known_args()
    global SITES
    SITES = args.sites
    if not torch.cuda.is_available():
        sys.exit("norm_ab.py: needs a CUDA card")
    flash_ab.G = torch.Generator(device=DEV).manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    if args.what == "unet":
        _build.build_all()
    else:
        build(args.src, flags, NAMES)
    {"check": check, "time": time_sites, "unet": unet}[args.what]()
    print(f"disagreeing cases: {flash_ab.FAILS}", flush=True)
    sys.exit(1 if flash_ab.FAILS else 0)


if __name__ == "__main__":
    main()
