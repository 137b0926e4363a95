"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:
  1. device   needs CUDA (no CPU fallback); prints the card's name and power
              limit as nvidia-smi reports them.
  2. build    compiles the five CUDA kernels (nvcc, sm_90a) from csrc/.
  3. kernels  each kernel against its plain PyTorch twin on the card, bf16,
              at the generation path's shapes (K2 also through the attention
              seam as the CLIP towers call it; K6 at the UNet's ds8 and ds16
              sites, the adaptor's and with zero-F frame pairs, on the
              flagship request's camera geometry): max abs error against the
              stated tolerance. Times (CUDA events) of the kernel, of the
              model's plain route for the same op (what the seam runs inside
              `ops.plain_twins()`: bf16 cuBLAS projections for K3 and K4),
              of the f32 reference twin, and of the one PyTorch library call
              that computes the same function where there is one
              (`F.group_norm` for K1, scaled dot-product attention for K2 and,
              with the materialised bool mask, for K6); the bound is the
              least time the card could take (larger of bytes over 3.35 TB/s
              and operations over 989 TFLOP/s bf16; K6 counts 4*D operations
              per set mask bit).
  4. unet     one full-width batch-2B UNet denoise step with the kernels
              against the same step inside `ops.plain_twins()`: DynamiCrafter,
              then CamContextI2V with a real camera payload; the second also
              profiled at batch 1 (device time by kernel, smoke_out/).
  5. generate DynamiCrafter-256 and CamContextI2V-256 (2 context frames, the
              bench camera trajectory) at full width, seeded random weights,
              bf16 on cuda:0, built by `presets.build`: three requests each
              (batch 1, batch 1 again, then batch 2; other images and seeds),
              the full 25-step DDIM recipe (eta 1.0, CFG 7.5, rescale 0.7,
              uniform_trailing) and VAE decode. Output shape
              (B, 16, 256, 256, 3) and finite; seconds per video; peak
              memory; the request's split into conditioning (`prepare_batch`:
              for CamContextI2V pose encoder, adaptor, CLIP, VAE encode), UNet
              calls, decode and the rest; the SM clock and power meanwhile.
  6. launches every kernel of each model's path launched during its requests
              (counts zeroed just before each model's requests, read after).
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

TOL_ULPS = 4  # kernel vs twin: 4 bf16 ulps (2^-6) of the reference's max |value|
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
OUT_DIR = "smoke_out"  # per-site K6 times, the step profile and a JSON summary


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


class _ClockSampler:
    """nvidia-smi sampling the SM clock, power draw and clock-event reasons
    every 200 ms while the block runs; the process is stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,clocks_event_reasons.active",
             "--format=csv,noheader,nounits", "-lms", "200"], stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        rows = [r.split(",") for r in self.proc.communicate(timeout=30)[0].splitlines()]
        try:
            clocks = sorted(float(r[0]) for r in rows)
            self.summary = (f"SM clock {clocks[0]:.0f}/{clocks[len(clocks) // 2]:.0f}/{clocks[-1]:.0f} MHz "
                            f"(min/median/max of {len(rows)} samples), power <= {max(float(r[1]) for r in rows):.0f} W, "
                            f"clock-event reasons {sorted({r[2].strip() for r in rows})}")
        except (IndexError, ValueError):
            self.summary = f"clocks not measured (nvidia-smi printed {rows[:1]})"
        return False


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(nbytes: float, flops: float) -> dict:
    """The least time for the work: bytes over the memory rate or operations
    over the bf16 tensor-core rate, whichever is larger."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_BF16 * 1e3
    return dict(bound_ms=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _compare(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    torch.cuda.synchronize()
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        _fail(f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)} or non-finite output")
    err = (got - ref).abs().max().item()
    tol = TOL_ULPS * 2.0 ** -8 * ref.abs().max().item()
    print(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} (max|ref|={ref.abs().max().item():.3e})", flush=True)
    if not err <= tol:
        _fail(f"{name}: kernel disagrees with its plain twin")
    return err


def _block(dev, c: int, heads: int):
    """A bf16 transformer block as the model builds it: seeded weights stored
    in bf16, norms f32."""
    from camc2v_tpu_torch.nn.attention import BasicTransformerBlock
    from camc2v_tpu_torch.utils.weights import cast_for_inference, init_weights

    with torch.device(dev):
        blk = BasicTransformerBlock(c, heads, 64, dtype=torch.bfloat16)
    init_weights(blk, torch.Generator(device=dev).manual_seed(3))
    return cast_for_inference(blk.eval(), torch.bfloat16)


def bench_camera(b: int, dev, t: int = 16, n_ctx: int = 2, img: int = 256) -> dict:
    """The flagship request's cameras (bench.py:_e2e_setup): intrinsics,
    target-frame w2c poses and context-frame w2c poses."""
    K = torch.tensor([[img, 0, img / 2], [0, img, img / 2], [0, 0, 1]], dtype=torch.float32, device=dev)
    w2c = torch.eye(4, device=dev).repeat(b, t, 1, 1)
    w2c[..., 0, 3] = torch.linspace(0, 1, t, device=dev)
    w2c[..., 1, 3] = 0.05
    w2c_cond = torch.eye(4, device=dev).repeat(b, n_ctx, 1, 1)
    w2c_cond[..., 0, 3] = -0.3
    return {"camera_intrinsics": K.expand(b, t, 3, 3).contiguous(), "RT": w2c, "RT_cond": w2c_cond}


def bench_F(dev, b: int = 1, perturb: bool = True):
    """(B, 16, 16, 3, 3) F of every frame pair of the bench trajectory, as
    CamI2V.camera_condition builds it (zero translations perturbed, or left
    zero so the same-frame pairs give F == 0)."""
    from camc2v_tpu_torch.camera import geometry as G

    cam = bench_camera(b, dev)
    pairs = G.relative_c2w_pairs(torch.linalg.inv(cam["RT"]))
    tvec = pairs[..., :3, 3:4]
    if perturb:
        noise = torch.randn(tvec.shape, generator=torch.Generator().manual_seed(0)).to(dev)
        tvec = G.add_small_perturbation(tvec, noise)
    K = cam["camera_intrinsics"][:, None].expand(b, 16, 16, 3, 3)
    return G.fundamental_matrix(K, pairs[..., :3, :3], tvec)


def epipolar_checks(dev, g) -> dict:
    """K6 against its chunked twin at the flagship's sites."""
    from camc2v_tpu_torch.camera import geometry as G
    from camc2v_tpu_torch.ops import epipolar_flash as ef

    bf = torch.bfloat16

    def case(F, t, h, w, ds, heads, nreg):
        lines = ef.epipolar_lines(F, h, w, ds)
        b, lq = lines.shape[0], lines.shape[1]
        hw = h * w
        bk = ef.choose_block_k(hw)
        tiles = ef.epipolar_tile_map(lines, t, h, w, ds, ef.BLOCK_Q, bk)
        q = torch.randn(b, lq, heads, 64, generator=g, device=dev).to(bf)
        k = torch.randn(b, t * hw + nreg, heads, 64, generator=g, device=dev).to(bf)
        v = torch.randn(b, t * hw + nreg, heads, 64, generator=g, device=dev).to(bf)
        kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
        run = lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles, **kw)  # noqa: E731
        twin = lambda: ef.epipolar_attention_plain(q, k, v, lines, **kw)  # noqa: E731
        # the bound counts the pairs whose mask bit is set; the pairs of the
        # subtiles the skip map leaves on are the work K6 does after skipping
        needed = ef.mask_pairs(lines, heads=heads, **kw)
        after_skip = ef.visible_pairs(tiles, heads=heads, t=t, hw=hw, num_registers=nreg, block_k=bk)
        return dict(run=run, twin=twin, q=q, k=k, v=v, lines=lines, kw=kw, skip=1 - tiles.float().mean().item(),
                    density=needed / (b * lq * heads * (t * hw + nreg)), pairs=needed, pairs_after_skip=after_skip,
                    after_skip_ms=4 * 64 * after_skip / PEAK_BF16 * 1e3,
                    **_bound(_nbytes(q, k, v, lines, tiles, q), 4 * 64 * needed))

    F = bench_F(dev, b=2)
    K = bench_camera(1, dev)
    F_adapt = G.conditional_fundamental(K["camera_intrinsics"], K["RT"], K["RT_cond"],
                                        torch.zeros(1, dtype=torch.long, device=dev))
    F_zero = bench_F(dev, b=1, perturb=False)
    # the adaptor: 16 frames x 1024 queries over the cond frame + 2 context
    # frames; frame 0's queries see the cond frame through F == 0 (NaN lines)
    cases = {
        "ds8 B=2 (2,16384,5,64)": case(F, 16, 32, 32, 8, 5, 4),
        "ds8 B=1 (1,16384,5,64)": case(F[:1], 16, 32, 32, 8, 5, 4),
        "ds16 B=2 (2,4096,10,64)": case(F, 16, 16, 16, 16, 10, 4),
        "ds16 B=1 (1,4096,10,64)": case(F[:1], 16, 16, 16, 16, 10, 4),
        "adaptor (1,16384,8,64) over 3 frames": case(F_adapt, 3, 32, 32, 8, 8, 2),
        "ds8 zero-F same-frame pairs (1,16384,5,64)": case(F_zero, 16, 32, 32, 8, 5, 4),
    }
    if not torch.isnan(cases["ds8 zero-F same-frame pairs (1,16384,5,64)"]["lines"]).any():
        _fail("the zero-F case has no NaN lines")
    errs, site_ms = [], {}
    for name, c in cases.items():
        errs.append(_compare(f"epipolar {name} skip={c['skip']:.3f}", c["run"](), c["twin"]()))
        site_ms[name] = dict(ms=_time_ms(c["run"]), bound_ms=c["bound_ms"], bound_by=c["bound_by"],
                             skip=c["skip"], mask_density=c["density"], pairs=c["pairs"],
                             pairs_after_skip=c["pairs_after_skip"], after_skip_ops_ms=c["after_skip_ms"])
        print(f"  time epipolar {name}: kernel {site_ms[name]['ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}; mask bits set {c['density']:.4f}), subtiles skipped {c['skip']:.3f}, "
              f"pairs after skipping {c['pairs_after_skip'] / c['pairs']:.2f}x the set bits "
              f"({c['after_skip_ms']:.4f} ms at the bf16 peak)", flush=True)
    main = cases["ds8 B=1 (1,16384,5,64)"]
    plain = _time_ms(main["twin"], reps=3)
    # the library call: scaled dot-product attention with the materialised
    # bool mask, registers first-class keys (padding dropped)
    q, k, v = main["q"], main["k"], main["v"]
    mask = torch.cat([ef.materialize_mask(main["lines"], 16, 32, 32, 8),
                      torch.ones(1, q.shape[1], 4, dtype=torch.bool, device=dev)], dim=-1)[:, None]
    if int(mask.sum()) * q.shape[2] != main["pairs"]:
        _fail("epipolar: the chunked count of set mask bits disagrees with the materialised mask")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        library = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                           reps=3)
    except torch.cuda.OutOfMemoryError:
        library = None
        print("  library call: out of memory at ds8 B=1, not measured", flush=True)
    del mask
    torch.cuda.empty_cache()
    print(f"  time epipolar_flash ds8 B=1: kernel {site_ms['ds8 B=1 (1,16384,5,64)']['ms']:.4f} ms, chunked twin "
          f"{plain:.4f} ms, library {library if library is None else round(library, 4)} ms", flush=True)
    with open(os.path.join(OUT_DIR, "epipolar_sites.json"), "w") as f:
        json.dump(site_ms, f, indent=1)
    s = site_ms["ds8 B=1 (1,16384,5,64)"]
    return dict(max_abs_err=max(errs), ms=s["ms"], plain_ms=plain, twin_ms=plain, bound_ms=s["bound_ms"],
                bound_by=s["bound_by"], library_ms=library, sites=site_ms)


@torch.no_grad()
def kernel_checks(dev) -> dict:
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.ops import flash_attention as fa
    from camc2v_tpu_torch.ops import geglu_ff as gff
    from camc2v_tpu_torch.ops import groupnorm as gn
    from camc2v_tpu_torch.ops import temporal_attention as ta
    from camc2v_tpu_torch.ops.attention import dot_product_attention, xla_attention

    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev) * scale).to(bf)  # noqa: E731
    f32n = lambda *s, scale=1.0, mean=0.0: torch.randn(*s, generator=g, device=dev) * scale + mean  # noqa: E731
    res = {}

    # K1: UNet 4-D (frames of the ds1 level), 5-D temporal at ds8, VAE 256^2
    errs = []
    for label, shape, silu, eps in [
        ("4-D silu", (32, 32, 32, 320), True, 1e-5), ("4-D", (32, 32, 32, 320), False, 1e-5),
        ("5-D silu", (2, 16, 4, 4, 1280), True, 1e-6), ("5-D", (2, 16, 4, 4, 1280), False, 1e-6),
        ("VAE 256^2 silu", (16, 256, 256, 128), True, 1e-6),
    ]:
        x = randn(*shape, scale=2.0) + 0.5
        s, b = f32n(shape[-1], scale=0.2, mean=1.0), f32n(shape[-1], scale=0.2)
        kw = dict(num_groups=32, eps=eps, silu=silu)
        errs.append(_compare(f"groupnorm {label} {shape}", gn.group_norm_fused(x, s, b, **kw),
                             gn.group_norm_plain(x, s, b, **kw)))
    x = randn(32, 32, 32, 320)
    s, b = f32n(320, scale=0.2, mean=1.0), f32n(320, scale=0.2)
    plain = _time_ms(lambda: gn.group_norm_plain(x, s, b, silu=True))
    # the library call computes GroupNorm without the SiLU, on the NCHW view
    xn = x.permute(0, 3, 1, 2)
    library = _time_ms(lambda: torch.nn.functional.group_norm(xn, 32, s.to(bf), b.to(bf), 1e-5))
    res["groupnorm"] = dict(max_abs_err=max(errs), ms=_time_ms(lambda: gn.group_norm_fused(x, s, b, silu=True)),
                            plain_ms=plain, twin_ms=plain, library_ms=library,
                            **_bound(2 * _nbytes(x) + _nbytes(s, b), 0))

    # K2: ds1 spatial self-attention, the same with a mask, text cross-attention (Lk=77)
    errs = []
    q, k, v = (randn(32, 1024, 5, 64) for _ in range(3))
    errs.append(_compare("flash self (32,1024,5,64)", fa.flash_attention(q, k, v),
                         xla_attention(q, k, v, mask=None, scale=64 ** -0.5)))
    mask = torch.rand(32, 1024, 1024, generator=g, device=dev) < 0.5
    mask |= torch.eye(1024, dtype=torch.bool, device=dev)[None]
    errs.append(_compare("flash masked (32,1024,5,64)", fa.flash_attention(q, k, v, mask=mask),
                         xla_attention(q, k, v, mask=mask[:, None], scale=64 ** -0.5)))
    kc, vc = randn(32, 77, 5, 64), randn(32, 77, 5, 64)
    errs.append(_compare("flash cross Lk=77", fa.flash_attention(q, kc, vc),
                         xla_attention(q, kc, vc, mask=None, scale=64 ** -0.5)))
    # through the seam, as the CLIP towers call it: the text tower's causal mask,
    # one (1, 1, 77, 77) tensor shared by the batch (its key tile 64..76 of query
    # tile 0..63 is empty and skipped), and the vision tower's D = 80 at L = 257
    causal = torch.ones(77, 77, dtype=torch.bool, device=dev).tril()[None, None]
    qt, kt, vt = (randn(3, 77, 16, 64) for _ in range(3))
    errs.append(_compare("seam CLIP text causal (3,77,16,64)", dot_product_attention(qt, kt, vt, mask=causal),
                         xla_attention(qt, kt, vt, mask=causal, scale=64 ** -0.5)))
    qv, kv, vv = (randn(2, 257, 16, 80) for _ in range(3))
    errs.append(_compare("seam CLIP vision (2,257,16,80)", dot_product_attention(qv, kv, vv),
                         xla_attention(qv, kv, vv, mask=None, scale=80 ** -0.5)))
    plain = _time_ms(lambda: xla_attention(q, k, v, mask=None, scale=64 ** -0.5))
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library = _time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))
    res["flash_attention"] = dict(max_abs_err=max(errs), ms=_time_ms(lambda: fa.flash_attention(q, k, v)),
                                  plain_ms=plain, twin_ms=plain, library_ms=library,
                                  **_bound(_nbytes(q, k, v, q), 4 * 64 * 32 * 5 * 1024 * 1024))

    # K3: ds1 temporal (N=2048, C=320, 5 heads) with LN+residual and without; init_attn
    # (C=512, 8 heads), ds2 (C=640) and the C=1280 levels
    errs = []
    for label, (n, c, heads), ln in [
        ("LN+res", (2048, 320, 5), True), ("plain", (2048, 320, 5), False), ("LN+res", (2048, 512, 8), True),
        ("LN+res", (512, 640, 10), True), ("LN+res", (128, 1280, 20), True),
    ]:
        x = randn(n, 16, c)
        wq, wk, wv, wo = (randn(c, c, scale=c ** -0.5) for _ in range(4))
        bo = f32n(c, scale=0.1)
        kw = dict(ln_scale=f32n(c, scale=0.2, mean=1.0), ln_bias=f32n(c, scale=0.2), residual=True) if ln else {}
        got = ta.fused_temporal_mha(x, wq, wk, wv, wo, bo, heads=heads, **kw)
        ref = ta.mha_plain(x, wq, wk, wv, wo, bo, kw.get("ln_scale"), kw.get("ln_bias"), heads=heads,
                           scale=64 ** -0.5, residual=ln)
        errs.append(_compare(f"temporal {label} ({n},16,{c})", got, ref))
    # timed on a ds1 transformer block as the model builds it: the kernel, the
    # block's own plain route (bf16 cuBLAS projections + the attention seam's
    # plain path, what `ops.plain_twins()` runs) and the f32 reference twin
    blk = _block(dev, 320, 5)
    attn, norm = blk.attn1, blk.norm1
    x = randn(2048, 16, 320)
    with ops.plain_twins():
        plain = _time_ms(lambda: attn(norm(x)) + x)
    n, t, c = x.shape
    k3_flops = 2 * n * t * c * 4 * c + 4 * n * t * t * c
    res["temporal_attention"] = dict(
        max_abs_err=max(errs), ms=_time_ms(lambda: attn.fused_self_attention(x, norm)), plain_ms=plain,
        twin_ms=_time_ms(lambda: ta.mha_plain(x, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
                                              attn.to_out.weight, attn.to_out.bias, norm.weight, norm.bias,
                                              heads=5, scale=0.125, residual=True)),
        library_ms=None,
        **_bound(2 * _nbytes(x) + _nbytes(attn.to_q.weight) * 4, k3_flops),
    )

    # K4: ds1 FF (rows 32768, C=320), init_attn (C=512), ds2 (C=640) and the C=1280 level
    errs = []
    for rows, c in [(32768, 320), (32768, 512), (8192, 640), (2048, 1280)]:
        x = randn(rows, c)
        ls, lb = f32n(c, scale=0.2, mean=1.0), f32n(c, scale=0.2)
        wp, bp = randn(8 * c, c, scale=c ** -0.5), f32n(8 * c, scale=0.1)
        wf, bfo = randn(c, 4 * c, scale=(4 * c) ** -0.5), f32n(c, scale=0.1)
        args = (x, ls, lb, wp, bp, wf, bfo)
        errs.append(_compare(f"geglu_ff ({rows},{c})", gff.fused_ln_geglu_ff(*args),
                             gff.ff_plain(*args, inner=4 * c, eps=1e-5)))
    # timed on the same ds1 block: its FeedForward's plain route is LN + two bf16
    # cuBLAS GEMMs with the (rows, 4C) hidden layer in HBM
    x = randn(32, 1024, 320)
    ff_args = (x, blk.norm3.weight, blk.norm3.bias, blk.ff.geglu.proj.weight, blk.ff.geglu.proj.bias,
               blk.ff.fc2.weight, blk.ff.fc2.bias)
    rows = 32 * 1024
    res["geglu_ff"] = dict(
        max_abs_err=max(errs), ms=_time_ms(lambda: gff.fused_ln_geglu_ff(*ff_args)),
        plain_ms=_time_ms(lambda: blk.ff(blk.norm3(x)) + x),
        twin_ms=_time_ms(lambda: gff.ff_plain(x.view(-1, 320), *ff_args[1:], inner=1280, eps=1e-5)),
        library_ms=None,
        **_bound(2 * _nbytes(x) + _nbytes(*ff_args[3:]), 2 * rows * 320 * 2560 + 2 * rows * 1280 * 320),
    )

    res["epipolar_flash"] = epipolar_checks(dev, g)
    for name, r in res.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"  time {name}: kernel {r['ms']:.4f} ms, model's plain route {r['plain_ms']:.4f} ms, "
              f"f32 reference twin {r['twin_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return res


def _rel_check(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    torch.cuda.synchronize()
    rel = ((got - ref).norm() / ref.norm()).item()
    print(f"  {name}: kernels vs plain twins rel_l2={rel:.3e} tol=5e-2 finite={bool(torch.isfinite(got).all())}",
          flush=True)
    if not (torch.isfinite(got).all() and rel <= 5e-2):
        _fail(f"{name}: the step with the kernels disagrees with the plain path")


def unet_check(model, dev) -> None:
    """One DynamiCrafter batch-2B denoise step, kernels vs plain twins."""
    from camc2v_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(7)
    cfg = model.config.unet
    x = torch.randn(2, 16, 32, 32, 8, generator=g, device=dev)
    ctx = torch.randn(2, 77 + 16 * 16, cfg.context_dim, generator=g, device=dev)
    t = torch.tensor([999, 999], device=dev)
    fs = torch.tensor([3, 3], device=dev)
    with torch.no_grad():
        got = model.unet(x, t, ctx, fs)
        with ops.plain_twins():
            ref = model.unet(x, t, ctx, fs)
    _rel_check("unet step (2,16,32,32,8)", got, ref)


def camcontext_batch(model, b: int, seed: int, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    cfg = model.config
    return {
        "video": torch.rand(b, 16, 256, 256, 3, generator=g, device=dev) * 2 - 1,
        "cond_frames": torch.rand(b, 2, 256, 256, 3, generator=g, device=dev) * 2 - 1,
        "caption_tokens": torch.randint(0, cfg.clip_text.vocab_size, (b, 77), generator=g, device=dev),
        "frame_stride": torch.full((b,), 3, dtype=torch.int32, device=dev),
        **bench_camera(b, dev),
    }


def camcontext_unet_check(model, dev) -> dict:
    """One CamContextI2V batch-2B UNet step with the bench camera payload
    (Plücker pyramid from the pose encoder, F, lines and tile maps), kernels
    vs plain twins; then a batch-1 step (the generation path's per-call
    batch) timed, and profiled for device time by kernel."""
    from camc2v_tpu_torch import ops

    g = torch.Generator(device=dev).manual_seed(8)
    cfg = model.config.unet
    batch = camcontext_batch(model, 2, 8, dev)
    with torch.no_grad():
        camera = model.camera_condition(batch, torch.zeros(2, dtype=torch.long, device=dev))
        x = torch.randn(2, 16, 32, 32, 8, generator=g, device=dev)
        ctx = torch.randn(2, 77 + 3 * 256, cfg.context_dim, generator=g, device=dev)
        t = torch.tensor([999, 999], device=dev)
        fs = torch.tensor([3, 3], device=dev)
        got = model.unet(x, t, ctx, fs, camera)
        with ops.plain_twins():
            ref = model.unet(x, t, ctx, fs, camera)
        _rel_check("camcontext unet step (2,16,32,32,8) with camera", got, ref)
        cam1 = model.camera_condition(camcontext_batch(model, 1, 9, dev), torch.zeros(1, dtype=torch.long,
                                                                                      device=dev))
        step = lambda: model.unet(x[:1], t[:1], ctx[:1], fs[:1], cam1)  # noqa: E731
        step_ms = _time_ms(step, reps=5)
        print(f"  camcontext unet step batch 1: {step_ms:.3f} ms", flush=True)
        by_kernel = {}
        try:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                dt = getattr(e, "device_time_total", None)
                if dt is None:
                    dt = getattr(e, "cuda_time_total", 0)
                if dt and e.key and not e.key.startswith("aten::") and "Memcpy" not in e.key:
                    ms, n = by_kernel.get(e.key, (0.0, 0))
                    by_kernel[e.key] = (ms + dt / 1e3, n + e.count)
        except RuntimeError as err:  # no profiler on this machine: the step time stands alone
            print(f"  profiler: {err}", flush=True)
        total = sum(ms for ms, _ in by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
        with open(os.path.join(OUT_DIR, "camcontext_step_profile.txt"), "w") as f:
            f.write(f"camcontext UNet step batch 1, device ms by kernel and calls (sum {total:.3f}, "
                    f"event-timed step {step_ms:.3f})\n")
            for key, (ms, n) in top:
                f.write(f"{ms:10.3f} {n:6d}  {key}\n")
        for key, (ms, n) in top[:12]:
            print(f"  profile {ms:8.3f} ms {n:5d} calls  {key[:100]}", flush=True)
        print(f"  profile: device time summed over kernels {total:.3f} ms", flush=True)
        k6_ms, k6_calls = by_kernel.get(next((k for k in by_kernel if "epipolar_fwd_kernel" in k), ""), (0.0, 0))
        print(f"  profile: K6 epipolar_fwd_kernel {k6_ms:.3f} ms over {k6_calls} calls", flush=True)
    return dict(step_ms=step_ms, profiled_ms=total, k6_profiled_ms=k6_ms, k6_profiled_calls=k6_calls)


def generate(model, make_batch, label: str, device_line: str) -> list:
    """Three requests (batch 1, batch 1 again, batch 2) through `model.sample`;
    CUDA events inside each time the conditioning (`prepare_batch`), every
    UNet call (`apply_model`) and the decode (`decode_first_stage`), so the
    rest of the request (sampler update math, host gaps) is what is left.
    The allocator's peak is read around each of them too."""
    out_lines = []
    events: dict[str, list] = {}
    peaks: dict[str, float] = {}
    real = {name: getattr(model, name) for name in ("prepare_batch", "apply_model", "decode_first_stage")}

    def fold_peak(name):
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()

    def timed(name):
        def call(*a, **k):
            fold_peak("rest")
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = real[name](*a, **k)
            e.record()
            events[name].append((s, e))
            fold_peak(name)
            return out
        return call

    for name in real:
        setattr(model, name, timed(name))
    try:
        for b, seed in [(1, 11), (1, 12), (2, 22)]:
            batch = make_batch(b, seed)
            g = torch.Generator(device=batch["video"].device).manual_seed(seed + 1)
            torch.cuda.reset_peak_memory_stats()
            peaks.clear()
            for name in real:
                events[name] = []
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with _ClockSampler() as clocks:
                start.record()
                video = model.sample(batch, generator=g, ddim_steps=25, ddim_eta=1.0, guidance_scale=7.5,
                                     guidance_rescale=0.7, timestep_spacing="uniform_trailing")
                end.record()
                torch.cuda.synchronize()
            sec = start.elapsed_time(end) / 1000.0
            ms = {name: [s.elapsed_time(e) for s, e in ev] for name, ev in events.items()}
            cond_s, dec_s = sum(ms["prepare_batch"]) / 1e3, sum(ms["decode_first_stage"]) / 1e3
            unet = ms["apply_model"]
            unet_s = sum(unet) / 1e3
            if tuple(video.shape) != (b, 16, 256, 256, 3) or not torch.isfinite(video).all():
                _fail(f"{label} request batch {b}: output {tuple(video.shape)} "
                      f"finite={bool(torch.isfinite(video).all())}")
            fold_peak("rest")
            peak = max(peaks.values())
            srt = sorted(unet)
            slow = sorted(range(len(unet)), key=lambda i: -unet[i])[:3]
            print(f"  {label} request batch={b} seed={seed}: out {tuple(video.shape)} finite, "
                  f"std={video.std().item():.4f}, {sec:.3f} s total, {sec / b:.3f} s/video, peak {peak:.2f} GiB, "
                  f"conditioning {cond_s:.3f} s ({cond_s / sec:.3f} of the request) [{device_line}]", flush=True)
            print(f"    split: conditioning {cond_s:.3f} s, {len(unet)} UNet calls {unet_s:.3f} s (min "
                  f"{srt[0]:.1f} / median {srt[len(srt) // 2]:.1f} / max {srt[-1]:.1f} ms; slowest calls "
                  f"{[(i, round(unet[i], 1)) for i in slow]}), decode {dec_s:.3f} s, rest "
                  f"{sec - cond_s - unet_s - dec_s:.3f} s; peak GiB by phase "
                  f"{ {name: round(gib, 2) for name, gib in peaks.items()} }; {clocks.summary}", flush=True)
            out_lines.append(dict(model=label, batch=b, seed=seed, seconds=sec, s_per_video=sec / b, peak_gib=peak,
                                  peak_gib_by_phase=dict(peaks), conditioning_s=cond_s, unet_calls_ms=unet,
                                  decode_s=dec_s, rest_s=sec - cond_s - unet_s - dec_s, clocks=clocks.summary))
    finally:
        for name in real:
            delattr(model, name)
    return out_lines


def main() -> None:
    if not torch.cuda.is_available():
        _fail("CUDA is not available (this smoke run needs the GPU; there is no CPU fallback)")
    from camc2v_tpu_torch import ops, presets
    from camc2v_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    device_line = _device_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)

    secs = _build.build_all()
    print(f"[2 build] {len(_build.KERNELS)} kernels built in {secs:.1f} s", flush=True)

    print("[3 kernels] kernel vs plain twin, bf16", flush=True)
    dc = presets.build("dynamicrafter_256", seed=1234)  # pins the card's numerics before the checks
    checks = kernel_checks(dev)

    print("[4 unet] full-width denoise steps", flush=True)
    unet_check(dc, dev)
    cc = presets.build("camcontexti2v_256", seed=4321)
    step = camcontext_unet_check(cc, dev)
    del cc  # one model on the card at a time, so each request's peak memory is its own
    torch.cuda.empty_cache()

    print("[5 generate] DynamiCrafter-256 and CamContextI2V-256, 25-step DDIM, CFG 7.5", flush=True)
    vocab = dc.config.clip_text.vocab_size

    def dc_batch(b, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return {
            "video": torch.rand(b, 16, 256, 256, 3, generator=g, device=dev) * 2 - 1,
            "caption_tokens": torch.randint(0, vocab, (b, 77), generator=g, device=dev),
            "frame_stride": torch.full((b,), 3, dtype=torch.int32, device=dev),
        }

    ops.reset_launch_counts()
    requests = generate(dc, dc_batch, "dynamicrafter", device_line)
    dc_launches = dict(ops.LAUNCHES)
    del dc
    torch.cuda.empty_cache()
    cc = presets.build("camcontexti2v_256", seed=4321)
    ops.reset_launch_counts()
    requests += generate(cc, lambda b, seed: camcontext_batch(cc, b, seed, dev), "camcontexti2v", device_line)
    launches = dict(ops.LAUNCHES)
    print(f"[6 launches] dynamicrafter {dc_launches}; camcontexti2v {launches}", flush=True)
    dc_path = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff")
    if not all(dc_launches[n] > 0 for n in dc_path) or not all(n > 0 for n in launches.values()):
        _fail(f"a kernel of a path was never launched: {dc_launches} / {launches}")

    with open(os.path.join(OUT_DIR, "chip_smoke_summary.json"), "w") as f:
        json.dump(dict(device=device_line, requests=requests, unet_step=step, launches_dynamicrafter=dc_launches,
                       launches_camcontexti2v=launches, kernels=checks), f, indent=1)
    sources = {
        "groupnorm": ("camc2v_tpu_torch/csrc/groupnorm.cu", "camc2v_tpu/ops/groupnorm.py:31"),
        "flash_attention": ("camc2v_tpu_torch/csrc/flash_attention.cu", "camc2v_tpu/ops/flash_attention.py:170"),
        "temporal_attention": ("camc2v_tpu_torch/csrc/temporal_attention.cu",
                               "camc2v_tpu/ops/temporal_attention.py:120"),
        "geglu_ff": ("camc2v_tpu_torch/csrc/geglu_ff.cu", "camc2v_tpu/ops/geglu_ff.py:92"),
        "epipolar_flash": ("camc2v_tpu_torch/csrc/epipolar_flash.cu", "camc2v_tpu/ops/epipolar_flash.py:226"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "twin_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             **{k: checks[name][k] for k in keys})
        for name, (src, rep) in sources.items()
    ]
    print(device_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
