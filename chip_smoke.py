"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:
  1. device   needs CUDA (no CPU fallback); prints the card's name and power
              limit as nvidia-smi reports them.
  2. build    compiles the four CUDA kernels (nvcc, sm_90a) from csrc/.
  3. kernels  each kernel against its plain PyTorch twin on the card, bf16,
              at the generation path's shapes (K2 also through the attention
              seam as the CLIP towers call it): max abs error against the
              stated tolerance. Times (CUDA events) of the kernel, of the
              model's plain route for the same op (what the seam runs inside
              `ops.plain_twins()`: bf16 cuBLAS projections for K3 and K4),
              and of the f32 reference twin (the same as the plain route for
              K1 and K2).
  4. unet     one full-width batch-2B UNet denoise step with the kernels
              against the same step inside `ops.plain_twins()`.
  5. generate DynamiCrafter-256 at full width, seeded random weights, bf16 on
              cuda:0: two requests (batch 1, then batch 2; other images and
              seeds), each the full 25-step DDIM recipe (eta 1.0, CFG 7.5,
              rescale 0.7, uniform_trailing) and VAE decode. Output shape
              (B, 16, 256, 256, 3) and finite; seconds per video; peak memory.
  6. launches every kernel launched during phase 5 (counts zeroed just
              before it).
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

TOL_ULPS = 4  # kernel vs twin: 4 bf16 ulps (2^-6) of the reference's max |value|


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


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
    randn = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev) * scale).to(bf)
    f32n = lambda *s, scale=1.0, mean=0.0: torch.randn(*s, generator=g, device=dev) * scale + mean
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
    res["groupnorm"] = dict(max_abs_err=max(errs), ms=_time_ms(lambda: gn.group_norm_fused(x, s, b, silu=True)),
                            plain_ms=plain, twin_ms=plain)

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
    res["flash_attention"] = dict(max_abs_err=max(errs), ms=_time_ms(lambda: fa.flash_attention(q, k, v)),
                                  plain_ms=plain, twin_ms=plain)

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
    res["temporal_attention"] = dict(
        max_abs_err=max(errs), ms=_time_ms(lambda: attn.fused_self_attention(x, norm)), plain_ms=plain,
        twin_ms=_time_ms(lambda: ta.mha_plain(x, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
                                              attn.to_out.weight, attn.to_out.bias, norm.weight, norm.bias,
                                              heads=5, scale=0.125, residual=True)),
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
    res["geglu_ff"] = dict(
        max_abs_err=max(errs), ms=_time_ms(lambda: gff.fused_ln_geglu_ff(*ff_args)),
        plain_ms=_time_ms(lambda: blk.ff(blk.norm3(x)) + x),
        twin_ms=_time_ms(lambda: gff.ff_plain(x.view(-1, 320), *ff_args[1:], inner=1280, eps=1e-5)),
    )
    for name, r in res.items():
        print(f"  time {name}: kernel {r['ms']:.4f} ms, model's plain route {r['plain_ms']:.4f} ms, "
              f"f32 reference twin {r['twin_ms']:.4f} ms", flush=True)
    return res


def build_model(dev):
    from camc2v_tpu_torch.models.dynamicrafter import DynamiCrafter
    from camc2v_tpu_torch.presets import dynamicrafter_256
    from camc2v_tpu_torch.utils.weights import cast_for_inference, init_weights

    with torch.device(dev):
        model = DynamiCrafter(dynamicrafter_256(), dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=dev).manual_seed(1234))
    return cast_for_inference(model.eval(), torch.bfloat16)


def unet_check(model, dev) -> None:
    """One batch-2B denoise step, kernels vs plain twins (relative L2)."""
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
    torch.cuda.synchronize()
    rel = ((got - ref).norm() / ref.norm()).item()
    print(f"  unet step (2,16,32,32,8): kernels vs plain twins rel_l2={rel:.3e} tol=5e-2 "
          f"finite={bool(torch.isfinite(got).all())}", flush=True)
    if not (torch.isfinite(got).all() and rel <= 5e-2):
        _fail("UNet step with the kernels disagrees with the plain path")


def generate(model, dev, device_line: str) -> list:
    cfg = model.config
    out_lines = []
    for b, seed in [(1, 11), (2, 22)]:
        g = torch.Generator(device=dev).manual_seed(seed)
        batch = {
            "video": torch.rand(b, 16, 256, 256, 3, generator=g, device=dev) * 2 - 1,
            "caption_tokens": torch.randint(0, cfg.clip_text.vocab_size, (b, 77), generator=g, device=dev),
            "frame_stride": torch.full((b,), 3, dtype=torch.int32, device=dev),
        }
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        video = model.sample(batch, generator=g, ddim_steps=25, ddim_eta=1.0, guidance_scale=7.5,
                             guidance_rescale=0.7, timestep_spacing="uniform_trailing")
        end.record()
        torch.cuda.synchronize()
        sec = start.elapsed_time(end) / 1000.0
        if tuple(video.shape) != (b, 16, 256, 256, 3) or not torch.isfinite(video).all():
            _fail(f"request batch {b}: output {tuple(video.shape)} finite={bool(torch.isfinite(video).all())}")
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        line = (f"  request batch={b}: out {tuple(video.shape)} finite, std={video.std().item():.4f}, "
                f"{sec:.3f} s total, {sec / b:.3f} s/video, peak {peak:.2f} GiB "
                f"[{device_line}]")
        print(line, flush=True)
        out_lines.append(dict(batch=b, seconds=sec, s_per_video=sec / b, peak_gib=peak))
    return out_lines


def main() -> None:
    if not torch.cuda.is_available():
        _fail("CUDA is not available (this smoke run needs the GPU; there is no CPU fallback)")
    import camc2v_tpu_torch
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.ops import _build

    camc2v_tpu_torch.configure_numerics()
    dev = torch.device("cuda:0")
    device_line = _device_line()
    print(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)

    secs = _build.build_all()
    print(f"[2 build] {len(_build.KERNELS)} kernels built in {secs:.1f} s", flush=True)

    print("[3 kernels] kernel vs plain twin, bf16", flush=True)
    checks = kernel_checks(dev)

    print("[4 unet] full-width denoise step", flush=True)
    model = build_model(dev)
    unet_check(model, dev)

    print("[5 generate] DynamiCrafter-256, 25-step DDIM, CFG 7.5", flush=True)
    ops.reset_launch_counts()
    generate(model, dev, device_line)
    launches = dict(ops.LAUNCHES)
    print(f"[6 launches] {launches}", flush=True)
    if not all(n > 0 for n in launches.values()):
        _fail(f"a kernel of the path was never launched: {launches}")

    sources = {
        "groupnorm": ("camc2v_tpu_torch/csrc/groupnorm.cu", "camc2v_tpu/ops/groupnorm.py:31"),
        "flash_attention": ("camc2v_tpu_torch/csrc/flash_attention.cu", "camc2v_tpu/ops/flash_attention.py:170"),
        "temporal_attention": ("camc2v_tpu_torch/csrc/temporal_attention.cu",
                               "camc2v_tpu/ops/temporal_attention.py:120"),
        "geglu_ff": ("camc2v_tpu_torch/csrc/geglu_ff.cu", "camc2v_tpu/ops/geglu_ff.py:92"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **checks[name])
        for name, (src, rep) in sources.items()
    ]
    print(device_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
