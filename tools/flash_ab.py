"""K2 and K5 (flash attention forward and backward) on one GPU: each held
against its plain twin, then timed beside scaled dot-product attention,
optionally built from another source directory or with extra nvcc flags, so
that variants of the kernels can be compared in one call, one process each:

    python3 tools/flash_ab.py check            # every K2/K5 case against the twins
    python3 tools/flash_ab.py time             # main-shape times of the tree's kernels
    python3 tools/flash_ab.py time --src DIR [-DNAME=VALUE ...]
                                               # the same, the two libraries built from DIR

`check` covers D = 16..128, ragged Lq and Lk, Lk = 77, per-batch and
batch-shared masks with fully masked rows, and the (32, 1024, 5, 64)
self-attention (4 bf16 ulps of the twin's max |value|, as chip_smoke.py).
`time` prints the CUDA-event time per call over 50 launches (and the host's
enqueue time) of K2 at (32, 1024, 5, 64), at Lk = 77 and masked at the ds32
epipolar shape, of K5 at (32, 1024, 5, 64) and Lk = 77 with its three
kernels' profiler device times, and SDPA and its backward at the main
shape. It also prints the registers and spills nvcc reported. Exit status 1
when a case disagrees.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from camc2v_tpu_torch.ops import _build  # noqa: E402
from camc2v_tpu_torch.ops import flash_attention as fa  # noqa: E402

DEV = torch.device("cuda:0")
G = None  # the inputs' generator, seeded in main()
FAILS = []


def rn(*shape):
    return torch.randn(*shape, generator=G, device=DEV).to(torch.bfloat16)


def dead_mask(b, lq, lk, p=0.5, dead=(0, 5, 130)):
    m = torch.rand(b, lq, lk, generator=G, device=DEV) < p
    for r in dead:
        if r < lq:
            m[:, r] = False
    return m


def compare(name, got, ref):
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    live = ref.abs() < 1e29  # a fully masked row's lse (+1e30) compared exactly
    if not torch.equal(got[~live], ref[~live]):
        FAILS.append(name)
    err = (got[live] - ref[live]).abs().max().item() if live.any() else 0.0
    tol = 4 * 2.0 ** -8 * ref[live].abs().max().item() if live.any() else 0.0
    ok = err <= tol and bool(torch.isfinite(got[live]).all())
    print(f"  {'ok ' if ok else 'BAD'} {name}: err {err:.3e} tol {tol:.3e}", flush=True)
    if not ok:
        FAILS.append(name)


@torch.no_grad()
def fwd_case(name, b, lq, lk, h, d, mask=None):
    q, k, v = rn(b, lq, h, d), rn(b, lk, h, d), rn(b, lk, h, d)
    out, lse = fa._launch_fwd(q, k, v, mask, d ** -0.5, want_lse=True)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, mask, d ** -0.5)
    compare(f"fwd {name} out", out, ref_out)
    compare(f"fwd {name} lse", lse, ref_lse)


@torch.no_grad()
def bwd_case(name, b, lq, lk, h, d, mask=None):
    q, k, v, dout = rn(b, lq, h, d), rn(b, lk, h, d), rn(b, lk, h, d), rn(b, lq, h, d)
    out, lse = fa.flash_fwd_plain(q, k, v, mask, d ** -0.5)
    args = (q, k, v, mask, out.contiguous(), lse, dout, d ** -0.5)
    for x, got, ref in zip("qkv", fa.flash_bwd(*args), fa.flash_bwd_plain(*args)):
        compare(f"bwd {name} d{x}", got, ref)


def check():
    causal = torch.ones(77, 77, dtype=torch.bool, device=DEV).tril()[None]
    fwd_case("one tile (1,128,1,64)", 1, 128, 128, 1, 64)
    fwd_case("causal shared (3,77,16,64)", 3, 77, 77, 16, 64, mask=causal)
    fwd_case("self (32,1024,5,64)", 32, 1024, 1024, 5, 64)
    for case in (bwd_case, fwd_case):
        case("ragged (2,300,3,64) over 200", 2, 300, 200, 3, 64)
        case("Lk=77 (4,1024,5,64)", 4, 1024, 77, 5, 64)
        case("masked, dead rows (3,1024,5,64)", 3, 1024, 1024, 5, 64, mask=dead_mask(3, 1024, 1024))
        case("shared sparse mask (2,300,4,64) over 700", 2, 300, 700, 4, 64, mask=dead_mask(1, 300, 700, 0.05))
        for d in (16, 32, 48, 80, 96, 112, 128):
            case(f"D={d} (2,257,4,{d})", 2, 257, 257, 4, d)
            case(f"D={d} masked (2,200,3,{d}) over 150", 2, 200, 150, 3, d, mask=dead_mask(2, 200, 150))
    bwd_case("self (32,1024,5,64)", 32, 1024, 1024, 5, 64)


def event_ms(fn, reps=50):
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
    return start.elapsed_time(end) / reps, host


def device_ms_by_kernel(fn, reps=10):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"flash_\w+", e.key)
        if name:
            dt = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out[name.group(0)] = out.get(name.group(0), 0.0) + dt / 1e3 / reps
    return out


def timing():
    q, k, v, dout = (rn(32, 1024, 5, 64) for _ in range(4))
    kc, vc = rn(32, 77, 5, 64), rn(32, 77, 5, 64)
    with torch.no_grad():
        ms, host = event_ms(lambda: fa._launch_fwd(q, k, v, None, 0.125, want_lse=False))
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        sdpa, _ = event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
        print(f"  K2 (32,1024,5,64): {ms:.4f} ms (host {host:.4f}), SDPA {sdpa:.4f} ms", flush=True)
        print(f"  K2 over 77: {event_ms(lambda: fa._launch_fwd(q, kc, vc, None, 0.125, want_lse=False))[0]:.4f} ms")
        m = dead_mask(2, 1024, 1028, 0.3)
        q2, k2, v2 = rn(2, 1024, 20, 64), rn(2, 1028, 20, 64), rn(2, 1028, 20, 64)
        print(f"  K2 masked (2,1024,20,64) over 1028: "
              f"{event_ms(lambda: fa._launch_fwd(q2, k2, v2, m, 0.125, want_lse=False))[0]:.4f} ms")
        out, lse = fa._launch_fwd(q, k, v, None, 0.125, want_lse=True)
        ms, host = event_ms(lambda: fa.flash_bwd(q, k, v, None, out, lse, dout, 0.125))
        parts = device_ms_by_kernel(lambda: fa.flash_bwd(q, k, v, None, out, lse, dout, 0.125))
        print(f"  K5 (32,1024,5,64): {ms:.4f} ms (host {host:.4f}); device by kernel "
              f"{ {k_: round(v_, 4) for k_, v_ in parts.items()} }", flush=True)
        oc, lc = fa._launch_fwd(q, kc, vc, None, 0.125, want_lse=True)
        print(f"  K5 over 77: {event_ms(lambda: fa.flash_bwd(q, kc, vc, None, oc, lc, dout, 0.125))[0]:.4f} ms")
    with torch.enable_grad():
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh)
        ms, _ = event_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True), 20)
    print(f"  SDPA backward (32,1024,5,64): {ms:.4f} ms", flush=True)


def build(src, flags, names=("flash_attention", "flash_bwd")):
    """Build the kernel libraries `names` (from `src` with `flags`, into a
    directory beside the package's build) and print nvcc's register report."""
    if src is None and not flags:
        _build.build_all(names)
        logs = {name: (_build.BUILD_DIR / f"{name}.log").read_text() for name in names}
    else:
        out_dir = _build.BUILD_DIR / "variant"
        out_dir.mkdir(parents=True, exist_ok=True)
        logs = {}
        for name in names:
            lib = out_dir / f"lib{name}.so"
            cmd = _build._command(name, lib)
            if src is not None:
                cmd = [c.replace(str(_build.CSRC), os.path.abspath(src)) for c in cmd]
            cmd[1:1] = flags
            run = subprocess.run(cmd, capture_output=True, text=True)
            logs[name] = run.stdout + run.stderr
            if run.returncode != 0:
                sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
            _build._LIBS[name] = ctypes.CDLL(str(lib))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7515" in line or "C7512" in line:
                print(f"  nvcc {name}: {line.split(':', 1)[-1].strip()[:150]}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("check", "time"))
    ap.add_argument("--src", default=None, help="build the two kernels from this source directory")
    args, flags = ap.parse_known_args()
    if not torch.cuda.is_available():
        sys.exit("flash_ab.py: needs a CUDA card")
    global G
    G = torch.Generator(device=DEV).manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    build(args.src, flags)
    check() if args.what == "check" else timing()
    print(f"disagreeing cases: {FAILS}", flush=True)
    sys.exit(1 if FAILS else 0)


if __name__ == "__main__":
    main()
