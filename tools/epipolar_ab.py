"""K6 and K7 (epipolar flash attention forward and backward) on one GPU: each
held against its plain twin, then timed beside scaled dot-product attention
with the materialised bool mask, optionally built from another source
directory or with extra nvcc flags, so that variants of the kernels can be
compared in one call, one process each:

    python3 tools/epipolar_ab.py check         # every K6/K7 case against the twins
    python3 tools/epipolar_ab.py time          # the training and generation sites' times
    python3 tools/epipolar_ab.py time --src DIR [-DNAME=VALUE ...]
                                               # the same, the two libraries built from DIR

`check` covers small layouts (4 frames of 16x16 at ds 8, D = 32, 64 and 128,
no registers, every row masked, a zero-F diagonal) and the flagship sites
(ds8 and ds16 of the UNet at batch 1 and 2, the adaptor over 3 frames),
the bench camera trajectory's geometry, within 4 bf16 ulps of the twin's
max |value| (as chip_smoke.py), fully masked rows' lse exactly +1e30.
`time` prints the CUDA-event time per call over 20 launches (and the host's
enqueue time) of K6 and K7 at each flagship site, the pairs the kernels
compute after skipping as a multiple of the set mask bits, and SDPA and its
backward with the bool mask at the same site. It also prints the registers
and spills nvcc reported. Exit status 1 when a case disagrees.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from camc2v_tpu_torch.camera import geometry as G  # noqa: E402
from camc2v_tpu_torch.ops import epipolar_flash as ef  # noqa: E402

import chip_smoke  # noqa: E402  (the bench trajectory's geometry, SDPA's bool mask)
import flash_ab  # noqa: E402  (inputs, comparison, timing and build, shared with K2/K5's tool)
from flash_ab import DEV, build, compare, event_ms, rn  # noqa: E402

NAMES = ("epipolar_flash", "epipolar_bwd")


def small_F(t, img, zero=None):
    """F of every frame pair of a small trajectory with distinct translations;
    `zero` (t, t) bool zeroes those pairs (NaN lines)."""
    K = torch.tensor([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], dtype=torch.float32, device=DEV)
    c2w = torch.eye(4, device=DEV).repeat(1, t, 1, 1)
    i = torch.arange(t, dtype=torch.float32, device=DEV)
    c2w[0, :, 0, 3], c2w[0, :, 1, 3], c2w[0, :, 2, 3] = 0.4 * i + 0.05, 0.1 * i, -0.15 * i
    pairs = G.relative_c2w_pairs(c2w)
    noise = torch.randn(pairs[..., :3, 3:4].shape, generator=torch.Generator().manual_seed(1)).to(DEV)
    F = G.fundamental_matrix(K.expand(1, t, t, 3, 3), pairs[..., :3, :3],
                             G.add_small_perturbation(pairs[..., :3, 3:4], noise))
    return F if zero is None else torch.where(zero[None, :, :, None, None], torch.zeros_like(F), F)


def flagship_sites(b):
    """(name, F, t, h, w, ds, heads, nreg) of the flagship's K6/K7 sites at batch b."""
    F = chip_smoke.bench_F(DEV, b=b)
    cam = chip_smoke.bench_camera(b, DEV)
    F_adapt = G.conditional_fundamental(cam["camera_intrinsics"], cam["RT"], cam["RT_cond"],
                                        torch.zeros(b, dtype=torch.long, device=DEV))
    return [(f"ds8 B={b} ({b},16384,5,64)", F, 16, 32, 32, 8, 5, 4),
            (f"ds16 B={b} ({b},4096,10,64)", F, 16, 16, 16, 16, 10, 4),
            (f"adaptor B={b} ({b},16384,8,64) over 3 frames", F_adapt, 3, 32, 32, 8, 8, 2)]


def inputs(F, t, h, w, ds, heads, nreg, d=64):
    lines = ef.epipolar_lines(F, h, w, ds)
    b, lq = lines.shape[:2]
    kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
    geom = dict(kw, scale=d ** -0.5, block_q=ef.BLOCK_Q, block_k=ef.choose_block_k(h * w))
    q, dout = rn(b, lq, heads, d), rn(b, lq, heads, d)
    k, v = rn(b, t * h * w + nreg, heads, d), rn(b, t * h * w + nreg, heads, d)
    return dict(q=q, k=k, v=v, dout=dout, lines=lines, tiles=ef.kernel_tile_map(lines, t, h, w, ds), kw=kw,
                geom=geom)


@torch.no_grad()
def case(name, F, t, h, w, ds, heads, nreg, d=64, backward=True):
    x = inputs(F, t, h, w, ds, heads, nreg, d)
    q, k, v, lines, tiles, geom = x["q"], x["k"], x["v"], x["lines"], x["tiles"], x["geom"]
    out, lse = ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=True)
    ref_out, ref_lse = ef.epipolar_attention_plain(q, k, v, lines, return_lse=True, scale=geom["scale"], **x["kw"])
    compare(f"K6 {name} out", out, ref_out)
    compare(f"K6 {name} lse", lse, ref_lse)
    gen, _ = ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=False)
    compare(f"K6 {name} out without lse", gen, ref_out)
    if backward:
        got = ef.epipolar_flash_bwd(q, k, v, lines, tiles, out, lse, x["dout"], geom)
        ref = ef.epipolar_bwd_plain(q, k, v, lines, out, lse, x["dout"], scale=geom["scale"], **x["kw"])
        for n, g_, r_ in zip("qkv", got, ref):
            compare(f"K7 {name} d{n}", g_, r_)
    return out


def check():
    t, hw = 4, 16
    zero_diag = torch.eye(t, dtype=torch.bool, device=DEV)
    for d in (32, 64, 128):
        case(f"small D={d} (1,1024,2,{d})", small_F(t, 128), t, hw, hw, 8, 2, 4, d=d)
    case("small, no registers", small_F(t, 128), t, hw, hw, 8, 2, 0)
    case("small, zero-F diagonal", small_F(t, 128, zero_diag), t, hw, hw, 8, 2, 4)
    out = case("small, every row masked (F = 0, no registers)",
               small_F(t, 128, torch.ones(t, t, dtype=torch.bool, device=DEV)), t, hw, hw, 8, 2, 0)
    if out.abs().max().item() != 0:
        flash_ab.FAILS.append("every row masked: output not 0")
    for b in (1, 2):
        for site in flagship_sites(b):
            case(*site)
    case("ds8 zero-F same-frame pairs (1,16384,5,64)", chip_smoke.bench_F(DEV, b=1, perturb=False), 16, 32, 32, 8,
         5, 4)


def timing():
    for b in (1, 2):
        for name, F, t, h, w, ds, heads, nreg in flagship_sites(b):
            x = inputs(F, t, h, w, ds, heads, nreg)
            q, k, v, lines, tiles, geom, dout = (x[n] for n in ("q", "k", "v", "lines", "tiles", "geom", "dout"))
            pairs = ef.mask_pairs(lines, heads=heads, **x["kw"])
            after = ef.visible_pairs(tiles, heads=heads, t=t, hw=h * w, num_registers=nreg, block_q=ef.KERNEL_BQ,
                                     block_k=ef.KERNEL_BK)
            with torch.no_grad():
                fwd, fhost = event_ms(lambda: ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=False), 20)
                out, lse = ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=True)
                bwd, bhost = event_ms(lambda: ef.epipolar_flash_bwd(q, k, v, lines, tiles, out, lse, dout, geom), 20)
            mask = chip_smoke._epipolar_mask(lines, t, h, w, ds, nreg)
            qh, kh, vh = (z.transpose(1, 2) for z in (q, k, v))
            with torch.no_grad():
                sdpa, _ = event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                                   5)
            with torch.enable_grad():
                qg, kg, vg = (z.detach().requires_grad_() for z in (qh, kh, vh))
                o = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
                sdpa_bwd, _ = event_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), dout.transpose(1, 2),
                                                                   retain_graph=True), 5)
            del mask, o
            torch.cuda.empty_cache()
            print(f"  {name}: K6 {fwd:.4f} ms (host {fhost:.4f}), SDPA {sdpa:.4f}; K7 {bwd:.4f} ms (host "
                  f"{bhost:.4f}), SDPA backward {sdpa_bwd:.4f}; pairs after skipping {after / pairs:.2f}x the set "
                  f"bits", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("check", "time"))
    ap.add_argument("--src", default=None, help="build the two kernels from this source directory")
    args, flags = ap.parse_known_args()
    if not torch.cuda.is_available():
        sys.exit("epipolar_ab.py: needs a CUDA card")
    flash_ab.G = torch.Generator(device=DEV).manual_seed(0)
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda, flush=True)
    build(args.src, flags, NAMES)
    check() if args.what == "check" else timing()
    print(f"disagreeing cases: {flash_ab.FAILS}", flush=True)
    sys.exit(1 if flash_ab.FAILS else 0)


if __name__ == "__main__":
    main()
