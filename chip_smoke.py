"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:
  1. device   needs CUDA (no CPU fallback); prints the card's name and power
              limit as nvidia-smi reports them.
  2. build    compiles the ten CUDA kernel libraries (nvcc, sm_90a) from
              csrc/, in parallel, and prints the registers, spills and shared
              memory that `-Xptxas -v` reports for the Hopper-core kernels
              (K2, K5, K6, K6p, K7 on the attention core; K3, K4 on the GEMM
              core); fails on a spill or a serialised `wgmma` in any of them,
              or when K2, K5, K6 or K7 take other registers than the
              recorded ones (`CORE_REGISTERS`); prints K6p's dynamic shared
              memory and blocks per SM at D = 64 and 128 (the runtime's
              occupancy) and fails unless two blocks fit at D = 64.
  3. kernels  each kernel against its plain PyTorch twin on the card, bf16,
              at the generation path's shapes (K2 also through the attention
              seam as the CLIP towers call it; K6 at the UNet's ds8 and ds16
              sites at batch 1 and 2, the adaptor's and with zero-F frame
              pairs, on the flagship request's camera geometry, and with
              fully masked rows): max abs error against the stated
              tolerance. Times (CUDA events) of the kernel, of the model's
              plain route for the same op (what the seam runs inside
              `ops.plain_twins()`: bf16 cuBLAS projections for K3 and K4), of
              the f32 reference twin, and of the one PyTorch library call
              that computes the same function where there is one
              (`F.group_norm` for K1, scaled dot-product attention for K2
              and, with the materialised bool mask, for K6 at every site);
              the bound is the least time the card could take (larger of
              bytes over 3.35 TB/s and operations over 989 TFLOP/s bf16; K6
              counts 4*D operations per set mask bit). K2 and K6 are also
              timed with the logsumexp output that training needs. The
              Hopper-core kernels (wgmma, TMA: K2, K5, K6, K7) are timed over
              50 back-to-back launches: CUDA events, the host's enqueue time
              per call and the profiler's device time per call; K6 and K7
              also print the pairs they compute after skipping as a multiple
              of the set mask bits, beside the multiple the JAX-tiling map
              would leave. K2 also at every distinct (B, Lq, Lk, H, D,
              masked) site of one CamContextI2V batch-1 UNet call (its
              launches captured by wrapping the wrapper's launch), each
              beside SDPA (with the call's bool mask where masked), with the
              launch-weighted sum per UNet call; K2's cases include a fully
              masked query row and the lse at Lk = 77. K3 and K4 (the GEMM
              core) at every distinct site of the same UNet call, captured
              the same way, on the call's own inputs: each against its twin,
              timed over 50 launches (events, host enqueue, profiler device
              time) beside the model's plain route for the op on a block of
              that width and the bound (24 rows C^2 operations for K4,
              8 rows C^2 + 4 rows T C for K3), with the launches per call and
              the launch-weighted sums per call. The training backward
              kernels K5 (flash dq/dk/dv) and K7 (epipolar dq/dk/dv, mask
              recomputed) against their chunked twins at the training
              sites, on the same forward outputs and logsumexp: dq, dk and
              dv each within 4 bf16 ulps of the twin's max |value|; timed
              beside the twin, the backward alone of scaled dot-product
              attention (with the materialised bool mask at each K7 site,
              at each K5 site) and the bound (10*D operations per query-key
              pair, per set mask bit for K7). K9 (the routes' GroupNorm)
              and K6p (the routes' epipolar attention on penalties): events,
              host enqueue and profiler device time per call beside the twin,
              the library call and the bound; K9 must run exactly its two
              kernels per call (no copy or memset in the profile) and give
              the same bits on two runs.
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
  6. launches every kernel of each model's generation path launched during its
              requests (counts zeroed just before each model's requests,
              read after).
  7. train    CamContextI2V-256 training at full width (`presets.
              build_for_training`, the flagship recipe: adaptor, Resampler and
              zero conv trained in fp32, the rest frozen in bf16, AdamW, clip
              0.5, accumulation 4, dropout 0.1, block remat), seeded random
              weights, 16 frames at 256x256 and 2 context frames: first one
              micro-step's trainable gradients with the kernels against the
              same step inside `ops.plain_twins()` (the train step's body with
              block remat on and ResBlock dropout off, batch 1, relative L2
              <= 5e-2); then `main.harness.Trainer.fit` for two
              optimizer steps x 4 micro-steps at batch 2 and one at batch 1,
              the counts zeroed just before and read just after (every kernel
              K1-K7 must launch): loss and grad norm finite, trainable
              parameters changed, frozen ones bit-identical; seconds per
              micro-step and optimizer step, samples/s, peak memory; the
              four batch-2 micro-steps of one more optimizer step of
              `make_train_step` split by CUDA events (conditioning and its
              parts, forward + loss, backward, optimizer) and one more
              micro-step profiled by kernel.
  8. routes   CamContextI2V-256 generation with the reference's opt-in
              routes, all five switches on (CAMC2V_EPI_PRECOMP,
              CAMC2V_LN_FUSED, CAMC2V_GN_TEMPORAL, CAMC2V_GN_BIG4D,
              CAMC2V_FUSED_CFG; phases 1-7 run with them off): one fused-CFG
              batch-2B UNet call (the uncond padded to the context's length,
              the penalties shared, not stacked) with the kernels against the
              same call inside `ops.plain_twins()`, relative L2 <= 5e-2, timed
              (events, host enqueue, profiler device time; K6p's, K6's, K9's
              and the row LN's device time in it), each route left out in
              turn; then
              two batch-1 DDIM requests, one at batch 2 and one batch-1
              13-step DPM++(2M) request (the bench recipe otherwise), each
              finite (B, 16, 256, 256, 3) with the split, peak memory and the
              penalties' bytes; counts zeroed just before the requests and
              read after: K6p (`epipolar_flash_precomp`), K8 (`layernorm`)
              and K9 (`groupnorm_temporal`) must launch, and K6 only in the
              adaptor (every UNet epipolar level is under the penalties' cap
              at batch 1 and 2). Phase 3 holds K6p (ds8 and ds16, penalties
              shared by a batch of 2), K8, K9 (a 5-D UNet site and the VAE's
              256x256 4-D view) and K10 (which has no model caller) against
              their twins.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

TOL_ULPS = 4  # kernel vs twin: 4 bf16 ulps (2^-6) of the reference's max |value|
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
OUT_DIR = "smoke_out"  # per-site K2/K5/K6/K7 times, the step profiles and a JSON summary
# the bench.py request recipe (25-step DDIM, CFG 7.5, rescale 0.7, eta 1,
# uniform_trailing; the package's `sample` defaults are the JAX package's)
BENCH_RECIPE = dict(ddim_steps=25, ddim_eta=1.0, guidance_scale=7.5, guidance_rescale=0.7,
                    timestep_spacing="uniform_trailing")
DPMPP_RECIPE = dict(BENCH_RECIPE, ddim_steps=13, sampler="dpmpp_2m")  # bench.py's throughput extra
ROUTE_SWITCHES = ("CAMC2V_EPI_PRECOMP", "CAMC2V_LN_FUSED", "CAMC2V_GN_TEMPORAL", "CAMC2V_GN_BIG4D",
                  "CAMC2V_FUSED_CFG")


@contextlib.contextmanager
def _switch(names, value: str):
    """The environment switches `names` (one name or several) set to `value`
    ("1" on, "0" off) for the block, the environment restored after."""
    names = (names,) if isinstance(names, str) else tuple(names)
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update({k: value for k in names})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _switches(value: str):
    """Every opt-in route switch set to `value` for the block."""
    return _switch(ROUTE_SWITCHES, value)


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


def _profiled_ms(fn, reps: int) -> float | None:
    """Device time per call of `reps` calls of `fn` by torch.profiler (every
    kernel the call launches), or None where the profiler shows none."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for e in prof.key_averages():
            if str(getattr(e, "device_type", "")).endswith("CUDA") and "Memcpy" not in e.key:
                total += getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        return total / 1e3 / reps if total else None
    except RuntimeError:
        return None


def _fmt(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _kernels_per_call(fn, reps: int = 10) -> dict:
    """{kernel: launches per call} of `reps` calls of `fn` by torch.profiler
    (device events only: kernels, memsets and copies), after a warm-up call;
    the kernel names without their template arguments."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            m = re.search(r"(\w+)\s*[<(]", e.key.replace("(anonymous namespace)", ""))
            name = m.group(1) if m else e.key
            out[name] = out.get(name, 0) + e.count / reps
    return out


def _time_kernel(fn, reps: int = 50) -> dict:
    """A fast kernel's time per call: CUDA events around `reps` back-to-back
    calls after a warm-up (`ms`), the host clock around the same loop without
    synchronising (`host_ms`, the enqueue time per call), and the profiler's
    device time per call for the same loop (`device_ms`)."""
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
    return dict(ms=start.elapsed_time(end) / reps, host_ms=host, device_ms=_profiled_ms(fn, reps))


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


def _compare_lse(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """lse against the twin's: exactly +1e30 on the fully masked rows (and
    only there), within the tolerance elsewhere."""
    torch.cuda.synchronize()
    dead = ref >= 1e30
    if not torch.equal(got >= 1e30, dead) or not bool((got[dead] == ref[dead]).all()):
        _fail(f"{name}: the fully masked rows differ ({int(dead.sum())} in the twin)")
    return _compare(f"{name} ({int(dead.sum())} fully masked rows exact)", got[~dead], ref[~dead])


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


def _epipolar_mask(lines, t, h, w, ds, nreg):
    """The (B, 1, Lq, t*hw + nreg) bool mask K6 computes, registers last:
    the SDPA yardstick's mask."""
    from camc2v_tpu_torch.ops import epipolar_flash as ef

    b, lq = lines.shape[:2]
    return torch.cat([ef.materialize_mask(lines, t, h, w, ds),
                      torch.ones(b, lq, nreg, dtype=torch.bool, device=lines.device)], dim=-1)[:, None]


def _skip_counts(lines, tiles, heads, t, h, w, ds, nreg) -> dict:
    """The set mask bits (the bound's work), the pairs of the tiles the
    kernels' map leaves on (their work after skipping) and, for comparison,
    of the subtiles the JAX-tiling map leaves on, with the share of tiles
    skipped."""
    from camc2v_tpu_torch.ops import epipolar_flash as ef

    kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
    hw, bk = h * w, ef.choose_block_k(h * w)
    pairs = ef.mask_pairs(lines, heads=heads, **kw)
    after = ef.visible_pairs(tiles, heads=heads, t=t, hw=hw, num_registers=nreg, block_q=ef.KERNEL_BQ,
                             block_k=ef.KERNEL_BK)
    coarse = ef.visible_pairs(ef.epipolar_tile_map(lines, t, h, w, ds, ef.BLOCK_Q, bk), heads=heads, t=t, hw=hw,
                              num_registers=nreg, block_k=bk)
    return dict(pairs=pairs, pairs_after_skip=after, after_skip_x=after / pairs, jax_map_after_skip_x=coarse / pairs,
                skip=1 - tiles.float().mean().item())


def epipolar_checks(dev, g) -> dict:
    """K6 against its chunked twin at the flagship's sites, each timed (50
    launches: events, host enqueue, profiler device time) beside SDPA with
    the site's bool mask."""
    from camc2v_tpu_torch.camera import geometry as G
    from camc2v_tpu_torch.ops import epipolar_flash as ef

    bf = torch.bfloat16

    def case(F, t, h, w, ds, heads, nreg):
        lines = ef.epipolar_lines(F, h, w, ds)
        b, lq = lines.shape[0], lines.shape[1]
        hw = h * w
        bk = ef.choose_block_k(hw)
        tiles = ef.kernel_tile_map(lines, t, h, w, ds)
        q = torch.randn(b, lq, heads, 64, generator=g, device=dev).to(bf)
        k = torch.randn(b, t * hw + nreg, heads, 64, generator=g, device=dev).to(bf)
        v = torch.randn(b, t * hw + nreg, heads, 64, generator=g, device=dev).to(bf)
        kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
        run = lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles, **kw)  # noqa: E731
        twin = lambda: ef.epipolar_attention_plain(q, k, v, lines, **kw)  # noqa: E731
        # the bound counts the pairs whose mask bit is set; the pairs of the
        # tiles the skip map leaves on are the work K6 does after skipping
        counts = _skip_counts(lines, tiles, heads, t, h, w, ds, nreg)
        return dict(run=run, twin=twin, q=q, k=k, v=v, lines=lines, tiles=tiles, kw=kw, bk=bk, **counts,
                    density=counts["pairs"] / (b * lq * heads * (t * hw + nreg)),
                    after_skip_ms=4 * 64 * counts["pairs_after_skip"] / PEAK_BF16 * 1e3,
                    **_bound(_nbytes(q, k, v, lines, tiles, q), 4 * 64 * counts["pairs"]))

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
        kern = _time_kernel(c["run"])
        mask = _epipolar_mask(c["lines"], *(c["kw"][n] for n in ("t", "h", "w", "downsample", "num_registers")))
        qh, kh, vh = c["q"].transpose(1, 2), c["k"].transpose(1, 2), c["v"].transpose(1, 2)
        sdpa = _time_kernel(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
                            reps=10)["ms"]
        if name == "ds8 B=1 (1,16384,5,64)" and int(mask.sum()) * c["q"].shape[2] != c["pairs"]:
            _fail("epipolar: the chunked count of set mask bits disagrees with the materialised mask")
        del mask
        torch.cuda.empty_cache()
        site_ms[name] = dict(ms=kern["ms"], host_ms=kern["host_ms"], device_ms=kern["device_ms"], sdpa_ms=sdpa,
                             bound_ms=c["bound_ms"], bound_by=c["bound_by"], skip=c["skip"],
                             mask_density=c["density"], pairs=c["pairs"], pairs_after_skip=c["pairs_after_skip"],
                             after_skip_x=c["after_skip_x"], jax_map_after_skip_x=c["jax_map_after_skip_x"],
                             after_skip_ops_ms=c["after_skip_ms"])
        print(f"  time epipolar {name}: kernel {kern['ms']:.4f} ms over 50 launches (host {kern['host_ms']:.4f}, "
              f"profiler {kern['device_ms']}), SDPA (bool mask) {sdpa:.4f} ms, bound {c['bound_ms']:.4f} ms "
              f"({c['bound_by']}; mask bits set {c['density']:.4f}), tiles skipped {c['skip']:.3f}, pairs after "
              f"skipping {c['after_skip_x']:.2f}x the set bits (the JAX-tiling map {c['jax_map_after_skip_x']:.2f}x; "
              f"{c['after_skip_ms']:.4f} ms at the bf16 peak)", flush=True)
    main = cases["ds8 B=1 (1,16384,5,64)"]
    plain = _time_ms(main["twin"], reps=3)
    # the training forward: K6 with its logsumexp, against the twin's
    geom = dict(main["kw"], scale=0.125, block_q=ef.BLOCK_Q, block_k=ef.BLOCK_K)
    with_lse = lambda: ef._launch_fwd(main["q"], main["k"], main["v"], main["lines"], main["tiles"],  # noqa: E731
                                      geom, want_lse=True)
    out_l, lse = with_lse()
    out_t, lse_t = ef.epipolar_attention_plain(main["q"], main["k"], main["v"], main["lines"], return_lse=True,
                                               **main["kw"])
    errs += [_compare("epipolar with lse ds8 B=1 out", out_l, out_t), _compare_lse("epipolar lse", lse, lse_t)]
    ms_with_lse = _time_kernel(with_lse)["ms"]
    # fully masked rows: query frames 0 and 1 see no frame (F = 0) and there
    # are no registers, so their rows give 0 and lse +1e30
    F_dead = F[:1].clone()
    F_dead[:, :2] = 0
    dead = case(F_dead, 16, 16, 16, 16, 10, 0)
    dgeom = dict(dead["kw"], scale=0.125, block_q=ef.BLOCK_Q, block_k=dead["bk"])
    out_d, lse_d = ef._launch_fwd(dead["q"], dead["k"], dead["v"], dead["lines"], dead["tiles"], dgeom,
                                  want_lse=True)
    ref_d, rlse_d = ef.epipolar_attention_plain(dead["q"], dead["k"], dead["v"], dead["lines"], return_lse=True,
                                                **dead["kw"])
    errs += [_compare("epipolar fully masked rows ds16 (1,4096,10,64) out", out_d, ref_d),
             _compare_lse("epipolar fully masked rows lse", lse_d, rlse_d)]
    if out_d[:, :512].abs().max().item() != 0 or not bool((lse_d[..., :512] >= 1e30).all()):
        _fail("epipolar: a fully masked row's output is not 0 or its lse not +1e30")
    s = site_ms["ds8 B=1 (1,16384,5,64)"]
    print(f"  time epipolar_flash ds8 B=1: kernel {s['ms']:.4f} ms (with the lse {ms_with_lse:.4f}), chunked twin "
          f"{plain:.4f} ms, library (SDPA, bool mask) {s['sdpa_ms']:.4f} ms", flush=True)
    with open(os.path.join(OUT_DIR, "epipolar_sites.json"), "w") as f:
        json.dump(site_ms, f, indent=1)
    return dict(max_abs_err=max(errs), ms=s["ms"], host_ms=s["host_ms"], device_ms=s["device_ms"],
                ms_with_lse=ms_with_lse, plain_ms=plain, twin_ms=plain, bound_ms=s["bound_ms"],
                bound_by=s["bound_by"], library_ms=s["sdpa_ms"], sites=site_ms)


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
    library = _time_kernel(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh))["ms"]
    # the training forward: K2 with its logsumexp, against the twin's
    out_l, lse = fa._launch_fwd(q, k, v, None, 64 ** -0.5, want_lse=True)
    out_t, lse_t = fa.flash_fwd_plain(q, k, v, None, 64 ** -0.5)
    errs += [_compare("flash with lse (32,1024,5,64) out", out_l, out_t), _compare_lse("flash lse", lse, lse_t)]
    # fully masked query rows (all of query tile 0, two rows of tile 1 and
    # row 700) with their lse, and the lse at Lk = 77 (one ragged key tile)
    dead = torch.rand(4, 1024, 1024, generator=g, device=dev) < 0.5
    dead[:, :130] = False
    dead[:, 700] = False
    out_d, lse_d = fa._launch_fwd(q[:4], k[:4], v[:4], dead, 0.125, want_lse=True)
    ref_d, rlse_d = fa.flash_fwd_plain(q[:4], k[:4], v[:4], dead, 0.125)
    errs += [_compare("flash fully masked rows (4,1024,5,64) out", out_d, ref_d),
             _compare_lse("flash fully masked rows lse", lse_d, rlse_d)]
    if out_d[:, :130].abs().max().item() != 0 or out_d[:, 700].abs().max().item() != 0:
        _fail("flash: a fully masked row's output is not 0")
    out_c, lse_c = fa._launch_fwd(q, kc, vc, None, 0.125, want_lse=True)
    ref_c, rlse_c = fa.flash_fwd_plain(q, kc, vc, None, 0.125)
    errs += [_compare("flash Lk=77 with lse out", out_c, ref_c), _compare_lse("flash Lk=77 lse", lse_c, rlse_c)]
    timed = _time_kernel(lambda: fa.flash_attention(q, k, v))
    res["flash_attention"] = dict(max_abs_err=max(errs), ms=timed["ms"], host_ms=timed["host_ms"],
                                  device_ms=timed["device_ms"],
                                  ms_with_lse=_time_kernel(lambda: fa._launch_fwd(q, k, v, None, 0.125,
                                                                                  want_lse=True))["ms"],
                                  plain_ms=plain, twin_ms=plain, library_ms=library,
                                  **_bound(_nbytes(q, k, v, q), 4 * 64 * 32 * 5 * 1024 * 1024))
    print(f"  time flash_attention (32,1024,5,64): kernel {timed['ms']:.4f} ms over 50 launches (host enqueue "
          f"{timed['host_ms']:.4f} ms per call, profiler device time {timed['device_ms']} ms per call)", flush=True)

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
    timed = _time_kernel(lambda: attn.fused_self_attention(x, norm))
    res["temporal_attention"] = dict(
        max_abs_err=max(errs), ms=timed["ms"], host_ms=timed["host_ms"], device_ms=timed["device_ms"],
        plain_ms=plain,
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
    timed = _time_kernel(lambda: gff.fused_ln_geglu_ff(*ff_args))
    res["geglu_ff"] = dict(
        max_abs_err=max(errs), ms=timed["ms"], host_ms=timed["host_ms"], device_ms=timed["device_ms"],
        plain_ms=_time_ms(lambda: blk.ff(blk.norm3(x)) + x),
        twin_ms=_time_ms(lambda: gff.ff_plain(x.view(-1, 320), *ff_args[1:], inner=1280, eps=1e-5)),
        library_ms=None,
        **_bound(2 * _nbytes(x) + _nbytes(*ff_args[3:]), 2 * rows * 320 * 2560 + 2 * rows * 1280 * 320),
    )

    res["epipolar_flash"] = epipolar_checks(dev, g)
    for name, r in res.items():
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        lse = f" (with the lse output {r['ms_with_lse']:.4f} ms)" if "ms_with_lse" in r else ""
        print(f"  time {name}: kernel {r['ms']:.4f} ms{lse}, model's plain route {r['plain_ms']:.4f} ms, "
              f"f32 reference twin {r['twin_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    return res


def _unet_call_inputs(model, dev, b: int = 1):
    """The inputs of one CamContextI2V UNet call at batch `b` (phase 4's
    step): latents, timestep, context of 77 text + 3 x 256 image tokens,
    frame stride and the bench camera's condition."""
    g = torch.Generator(device=dev).manual_seed(8)
    cfg = model.config.unet
    camera = model.camera_condition(camcontext_batch(model, b, 9, dev), torch.zeros(b, dtype=torch.long, device=dev))
    x = torch.randn(b, 16, 32, 32, 8, generator=g, device=dev)
    ctx = torch.randn(b, 77 + 3 * 256, cfg.context_dim, generator=g, device=dev)
    return x, torch.full((b,), 999, device=dev), ctx, torch.full((b,), 3, device=dev), camera


@torch.no_grad()
def flash_site_checks(model, dev) -> dict:
    """K2 at every distinct (B, Lq, Lk, H, D, masked) site of one
    CamContextI2V batch-1 UNet call: the call's launches are captured by
    wrapping the wrapper's launch (`_launch_fwd`), then each site is timed
    on seeded inputs with the call's own mask, beside SDPA (with that bool
    mask), with its bound (4 D operations per visible pair; bytes: q, k, v,
    the mask read and out written); the launch-weighted sum per UNet call."""
    from camc2v_tpu_torch.ops import flash_attention as fa

    seen, masks = {}, {}
    real = fa._launch_fwd

    def spy(q, k, v, mask, scale, *, want_lse):
        key = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], q.shape[3], mask is not None)
        seen[key] = seen.get(key, 0) + 1
        if mask is not None and key not in masks:
            masks[key] = (mask.clone(), scale)
        masks.setdefault(key, (None, scale))
        return real(q, k, v, mask, scale, want_lse=want_lse)

    x, t, ctx, fs, camera = _unet_call_inputs(model, dev)
    fa._launch_fwd = spy
    try:
        model.unet(x, t, ctx, fs, camera)
    finally:
        fa._launch_fwd = real
    g = torch.Generator(device=dev).manual_seed(5)
    sites, total, total_sdpa, total_bound = {}, 0.0, 0.0, 0.0
    for key, n in sorted(seen.items(), key=lambda kv: -kv[1]):
        b, lq, lk, h, d, masked = key
        mask, scale = masks[key]
        q = torch.randn(b, lq, h, d, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(b, lk, h, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
        kern = _time_kernel(lambda: fa._launch_fwd(q, k, v, mask, scale, want_lse=False))
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        am = None if mask is None else mask[:, None]
        sdpa = _time_kernel(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=am,
                                                                                     scale=scale))["ms"]
        pairs = b * h * lq * lk if mask is None else int(mask.expand(b, lq, lk).sum()) * h
        bound = _bound(_nbytes(q, k, v, q) + (0 if mask is None else _nbytes(mask)), 4 * d * pairs)
        name = f"({b},{lq},{h},{d}) over {lk}{' masked' if masked else ''}"
        sites[name] = dict(launches_per_call=n, ms=kern["ms"], host_ms=kern["host_ms"], device_ms=kern["device_ms"],
                           sdpa_ms=sdpa, **bound)
        total += n * kern["ms"]
        total_sdpa += n * sdpa
        total_bound += n * bound["bound_ms"]
        print(f"  time flash_attention site {name}: {n} launches per UNet call, kernel {kern['ms']:.4f} ms (host "
              f"{kern['host_ms']:.4f}, profiler {kern['device_ms']}), SDPA {sdpa:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    launches = sum(seen.values())
    print(f"  flash_attention over one CamContextI2V batch-1 UNet call: {launches} launches at {len(seen)} sites, "
          f"launch-weighted kernel {total:.3f} ms, SDPA {total_sdpa:.3f} ms, bound {total_bound:.3f} ms", flush=True)
    with open(os.path.join(OUT_DIR, "flash_sites.json"), "w") as f:
        json.dump(sites, f, indent=1)
    return dict(sites=sites, launches_per_call=launches, weighted_ms=total, weighted_sdpa_ms=total_sdpa,
                weighted_bound_ms=total_bound)


@torch.no_grad()
def ff_mha_site_checks(model, dev) -> dict:
    """K4 and K3 at every distinct site of one CamContextI2V batch-1 UNet
    call: the call's launches are captured by wrapping the wrappers' launches
    (`_launch`), each site's first inputs kept (the call's activations and
    the model's weights). At each site the kernel against its plain twin on
    those inputs; the kernel timed over 50 launches (events, host enqueue,
    profiler device time); the model's plain route for the op (what
    `ops.plain_twins()` runs: LN + two bf16 cuBLAS GEMMs for K4, the block's
    LN, projections and attention seam for K3) on a block of that width; the
    bound; the launch-weighted sums per UNet call of the kernel, the plain
    route and the bound, per kernel."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.ops import geglu_ff as gff
    from camc2v_tpu_torch.ops import temporal_attention as ta

    seen, inputs = {}, {}
    real_ff, real_mha = gff._launch, ta._launch

    def spy_ff(x2, *w, eps):
        key = ("geglu_ff", x2.shape[0], x2.shape[1])
        seen[key] = seen.get(key, 0) + 1
        inputs.setdefault(key, (x2.clone(), w, dict(eps=eps)))
        return real_ff(x2, *w, eps=eps)

    def spy_mha(x, *w, **kw):
        key = ("temporal_attention", *x.shape, kw["heads"], w[5] is not None, kw["residual"])
        seen[key] = seen.get(key, 0) + 1
        inputs.setdefault(key, (x.clone(), w, kw))
        return real_mha(x, *w, **kw)

    gff._launch, ta._launch = spy_ff, spy_mha
    try:
        model.unet(*_unet_call_inputs(model, dev))
    finally:
        gff._launch, ta._launch = real_ff, real_mha
    blocks = {}
    sites = {"geglu_ff": {}, "temporal_attention": {}}
    sums = {k: dict(launches_per_call=0, weighted_ms=0.0, weighted_plain_ms=0.0, weighted_bound_ms=0.0)
            for k in sites}
    errs = {k: [] for k in sites}
    for key, n in sorted(seen.items(), key=lambda kv: (kv[0][0], -kv[1], kv[0])):
        x, w, kw = inputs[key]
        c = x.shape[-1]
        if c not in blocks:
            blocks[c] = _block(dev, c, c // 64)
        blk = blocks[c]
        if key[0] == "geglu_ff":
            rows = x.shape[0]
            name = f"({rows}, {c})"
            kern = lambda: real_ff(x, *w, **kw)  # noqa: E731
            ref = gff.ff_plain(x, *w, inner=w[4].shape[1], eps=kw["eps"])
            xb = x.view(1, rows, c)
            plain = lambda: blk.ff(blk.norm3(xb)) + xb  # noqa: E731
            bound = _bound(2 * _nbytes(x) + _nbytes(w[2], w[4]), 24 * rows * c * c)
        else:
            _, nseq, t, _, heads, ln, residual = key
            rows = nseq * t
            name = f"({nseq}, {t}, {c}) heads {heads}{' LN+res' if ln else ''}"
            kern = lambda: real_mha(x, *w, **kw)  # noqa: E731
            ref = ta.mha_plain(x, *w, heads=heads, scale=kw["scale"], residual=residual, eps=kw["eps"])
            attn, norm = blk.attn1, blk.norm1

            def plain(x=x, attn=attn, norm=norm, ln=ln):
                with ops.plain_twins():
                    return attn(norm(x)) + x if ln else attn(x)
            bound = _bound(2 * _nbytes(x) + _nbytes(*w[:4]), 8 * rows * c * c + 4 * rows * t * c)
        errs[key[0]].append(_compare(f"{key[0]} UNet-call site {name}", kern(), ref))
        timed = _time_kernel(kern)
        plain_ms = _time_kernel(plain)["ms"]
        sites[key[0]][name] = dict(launches_per_call=n, ms=timed["ms"], host_ms=timed["host_ms"],
                                   device_ms=timed["device_ms"], plain_ms=plain_ms, **bound)
        tot = sums[key[0]]
        tot["launches_per_call"] += n
        tot["weighted_ms"] += n * timed["ms"]
        tot["weighted_plain_ms"] += n * plain_ms
        tot["weighted_bound_ms"] += n * bound["bound_ms"]
        print(f"  time {key[0]} site {name}: {n} launches per UNet call, kernel {timed['ms']:.4f} ms (host "
              f"{timed['host_ms']:.4f}, profiler {timed['device_ms']}), plain route {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})", flush=True)
    for k, tot in sums.items():
        print(f"  {k} over one CamContextI2V batch-1 UNet call: {tot['launches_per_call']} launches at "
              f"{len(sites[k])} sites, launch-weighted kernel {tot['weighted_ms']:.3f} ms, plain route "
              f"{tot['weighted_plain_ms']:.3f} ms, bound {tot['weighted_bound_ms']:.3f} ms", flush=True)
    with open(os.path.join(OUT_DIR, "ff_mha_sites.json"), "w") as f:
        json.dump(sites, f, indent=1)
    del blocks
    torch.cuda.empty_cache()
    return {k: dict(sites=sites[k], max_abs_err=max(errs[k]), **sums[k]) for k in sites}


def _sdpa_backward_ms(q, k, v, dout, mask=None, reps: int = 5) -> float:
    """The backward alone of scaled dot-product attention on (B, L, H, D)
    inputs, the library yardstick of K5 and K7 (the port never calls it):
    one forward, then the gradient call timed."""
    with torch.enable_grad():
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        return _time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), dout.transpose(1, 2), retain_graph=True),
                        reps)


def _bwd_bound(q, k, v, out, dout, lse, pairs: int, extra=()) -> dict:
    """The backward's least time: q, k, v, out, dout read and dq, dk, dv
    written in bf16, lse and delta in f32 (plus `extra` inputs), and 10*D
    operations per query-key pair (the score and dp products, then ds.k,
    ds.q and p.dout)."""
    return _bound(_nbytes(q, k, v, out, dout) + _nbytes(q, k, v) + 2 * _nbytes(lse) + _nbytes(*extra),
                  10 * q.shape[-1] * pairs)


def _bwd_compare(name: str, got, ref) -> float:
    return max(_compare(f"{name} d{x}", g, r) for x, g, r in zip("qkv", got, ref))


@torch.no_grad()
def backward_checks(dev) -> dict:
    """K5 and K7 against their chunked twins at the training sites (batch 2),
    on the same inputs: q, k, v, dout drawn from a seed, out and lse from the
    forward kernel (K2, K6)."""
    from camc2v_tpu_torch.camera import geometry as G
    from camc2v_tpu_torch.ops import epipolar_flash as ef
    from camc2v_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    res = {}

    def flash_case(b, lq, lk, h, mask=None):
        q, k, v, dout = randn(b, lq, h, 64), randn(b, lk, h, 64), randn(b, lk, h, 64), randn(b, lq, h, 64)
        out, lse = fa._launch_fwd(q, k, v, mask, 0.125, want_lse=True)
        args = (q, k, v, mask, out, lse, dout, 0.125)
        pairs = b * h * lq * lk if mask is None else int(mask.sum()) * h
        return dict(run=lambda: fa.flash_bwd(*args), twin=lambda: fa.flash_bwd_plain(*args), q=q, k=k, v=v,
                    dout=dout, mask=mask, **_bwd_bound(q, k, v, out, dout, lse, pairs, () if mask is None else (mask,)))

    # the ds32 epipolar level through K2: 16 frames of 8x8 over 4 registers (first) + 1024 keys
    lines32 = ef.epipolar_lines(bench_F(dev, b=2), 8, 8, 32)
    mask32 = torch.cat([torch.ones(2, 1024, 4, dtype=torch.bool, device=dev),
                        ef.materialize_mask(lines32, 16, 8, 8, 32)], dim=-1)
    flash_sites = {
        "spatial self (32,1024,5,64)": flash_case(32, 1024, 1024, 5),
        "text cross (32,1024,5,64) over 77": flash_case(32, 1024, 77, 5),
        "image cross (32,1024,5,64) over 768": flash_case(32, 1024, 768, 5),
        "ds32 epipolar masked (2,1024,20,64) over 1028": flash_case(2, 1024, 1028, 20, mask32),
    }
    errs, sites = [], {}
    for name, c in flash_sites.items():
        errs.append(_bwd_compare(f"flash_bwd {name}", c["run"](), c["twin"]()))
        kern = _time_kernel(c["run"])
        mask = None if c["mask"] is None else c["mask"][:, None]
        sites[name] = dict(ms=kern["ms"], host_ms=kern["host_ms"], device_ms=kern["device_ms"],
                           twin_ms=_time_ms(c["twin"], reps=2),
                           sdpa_backward_ms=_sdpa_backward_ms(c["q"], c["k"], c["v"], c["dout"], mask=mask, reps=20),
                           bound_ms=c["bound_ms"], bound_by=c["bound_by"])
        st = sites[name]
        print(f"  time flash_bwd {name}: kernel {st['ms']:.4f} ms over 50 launches (host {st['host_ms']:.4f}, "
              f"profiler {st['device_ms']}), twin {st['twin_ms']:.4f} ms, SDPA backward "
              f"{st['sdpa_backward_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})", flush=True)
    s = sites["spatial self (32,1024,5,64)"]
    res["flash_bwd"] = dict(max_abs_err=max(errs), ms=s["ms"], host_ms=s["host_ms"], device_ms=s["device_ms"],
                            plain_ms=s["twin_ms"], twin_ms=s["twin_ms"], bound_ms=s["bound_ms"],
                            bound_by=s["bound_by"], library_ms=s["sdpa_backward_ms"], sites=sites)

    def epi_case(F, t, h, w, ds, heads, nreg):
        lines = ef.epipolar_lines(F, h, w, ds)
        b, lq = lines.shape[:2]
        bk = ef.choose_block_k(h * w)
        tiles = ef.kernel_tile_map(lines, t, h, w, ds)
        q, dout = randn(b, lq, heads, 64), randn(b, lq, heads, 64)
        k, v = randn(b, t * h * w + nreg, heads, 64), randn(b, t * h * w + nreg, heads, 64)
        kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
        geom = dict(kw, scale=0.125, block_q=ef.BLOCK_Q, block_k=bk)
        out, lse = ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=True)
        counts = _skip_counts(lines, tiles, heads, t, h, w, ds, nreg)
        return dict(run=lambda: ef.epipolar_flash_bwd(q, k, v, lines, tiles, out, lse, dout, geom),
                    twin=lambda: ef.epipolar_bwd_plain(q, k, v, lines, out, lse, dout, scale=0.125, **kw),
                    q=q, k=k, v=v, dout=dout, lines=lines, kw=kw, **counts,
                    **_bwd_bound(q, k, v, out, dout, lse, counts["pairs"], (lines, tiles)))

    F = bench_F(dev, b=2)
    cam = bench_camera(2, dev)
    F_adapt = G.conditional_fundamental(cam["camera_intrinsics"], cam["RT"], cam["RT_cond"],
                                        torch.zeros(2, dtype=torch.long, device=dev))
    epi_sites = {
        "ds8 B=2 (2,16384,5,64)": epi_case(F, 16, 32, 32, 8, 5, 4),
        "ds8 B=1 (1,16384,5,64)": epi_case(F[:1], 16, 32, 32, 8, 5, 4),
        "ds16 B=2 (2,4096,10,64)": epi_case(F, 16, 16, 16, 16, 10, 4),
        "adaptor B=2 (2,16384,8,64) over 3 frames": epi_case(F_adapt, 3, 32, 32, 8, 8, 2),
        "ds8 zero-F same-frame pairs (1,16384,5,64)": epi_case(bench_F(dev, b=1, perturb=False), 16, 32, 32, 8, 5, 4),
    }
    errs, sites = [], {}
    for name, c in epi_sites.items():
        errs.append(_bwd_compare(f"epipolar_bwd {name}", c["run"](), c["twin"]()))
        kern = _time_kernel(c["run"])
        mask = _epipolar_mask(c["lines"], *(c["kw"][n] for n in ("t", "h", "w", "downsample", "num_registers")))
        sdpa = _sdpa_backward_ms(c["q"], c["k"], c["v"], c["dout"], mask=mask, reps=5)
        del mask
        torch.cuda.empty_cache()
        sites[name] = dict(ms=kern["ms"], host_ms=kern["host_ms"], device_ms=kern["device_ms"],
                           sdpa_backward_ms=sdpa, bound_ms=c["bound_ms"], bound_by=c["bound_by"], skip=c["skip"],
                           pairs=c["pairs"], pairs_after_skip=c["pairs_after_skip"], after_skip_x=c["after_skip_x"],
                           jax_map_after_skip_x=c["jax_map_after_skip_x"])
        print(f"  time epipolar_bwd {name}: kernel {kern['ms']:.4f} ms over 50 launches (host {kern['host_ms']:.4f}, "
              f"profiler {kern['device_ms']}), SDPA backward (bool mask) {sdpa:.4f} ms, bound {c['bound_ms']:.4f} "
              f"ms ({c['bound_by']}), pairs after skipping {c['after_skip_x']:.2f}x the set bits (the JAX-tiling "
              f"map {c['jax_map_after_skip_x']:.2f}x)", flush=True)
    twin = _time_ms(epi_sites["ds8 B=1 (1,16384,5,64)"]["twin"], reps=1)
    s = sites["ds8 B=1 (1,16384,5,64)"]
    print(f"  time epipolar_bwd ds8 B=1: kernel {s['ms']:.4f} ms, chunked twin {twin:.4f} ms, library (SDPA "
          f"backward, bool mask) {s['sdpa_backward_ms']:.4f} ms", flush=True)
    res["epipolar_bwd"] = dict(max_abs_err=max(errs), ms=s["ms"], host_ms=s["host_ms"], device_ms=s["device_ms"],
                               plain_ms=twin, twin_ms=twin, bound_ms=s["bound_ms"], bound_by=s["bound_by"],
                               library_ms=s["sdpa_backward_ms"], sites=sites)
    with open(os.path.join(OUT_DIR, "backward_sites.json"), "w") as f:
        json.dump({k: v["sites"] for k, v in res.items()}, f, indent=1)
    return res


@torch.no_grad()
def route_kernel_checks(dev) -> dict:
    """K8, K9, K10 and K6p, the opt-in routes' kernels, against their plain
    twins at the routes path's shapes, timed beside the twin (which is also
    the seam's plain route), the library call and the bound."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.ops import epipolar_flash as ef
    from camc2v_tpu_torch.ops import groupnorm as gn
    from camc2v_tpu_torch.ops import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    randn = lambda *s, scale=1.0, mean=0.0: (torch.randn(*s, generator=g, device=dev) * scale + mean)  # noqa: E731
    res = {}

    # K8: a UNet transformer norm at ds1 and the CLIP towers' widths
    errs = []
    for label, shape in [("UNet ds1 (32768, 320)", (32768, 320)), ("CLIP vision (1028, 1280)", (1028, 1280)),
                         ("CLIP text (154, 1024)", (154, 1024))]:
        x = randn(*shape, scale=1.5, mean=0.3).to(bf)
        s_, b_ = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        errs.append(_compare(f"layernorm {label}", ln.layer_norm_fused(x, s_, b_), ln.layer_norm_plain(x, s_, b_)))
    x = randn(32768, 320, scale=1.5, mean=0.3).to(bf)
    s_, b_ = randn(320, scale=0.2, mean=1.0), randn(320, scale=0.2)
    plain = _time_ms(lambda: ln.layer_norm_plain(x, s_, b_))
    default = _time_ms(lambda: torch.nn.functional.layer_norm(x.float(), (320,), s_, b_, 1e-5).to(bf))
    library = _time_ms(lambda: torch.nn.functional.layer_norm(x, (320,), s_.to(bf), b_.to(bf), 1e-5))
    t8 = _time_kernel(lambda: ln.layer_norm_fused(x, s_, b_))
    res["layernorm"] = dict(max_abs_err=max(errs), ms=t8["ms"], host_ms=t8["host_ms"], device_ms=t8["device_ms"],
                            plain_ms=plain, twin_ms=plain, library_ms=library, default_route_ms=default,
                            **_bound(2 * _nbytes(x) + _nbytes(s_, b_), 0))
    print(f"  time layernorm (32768, 320): {t8['ms']:.4f} ms (host {t8['host_ms']:.4f}, device "
          f"{_fmt(t8['device_ms'])})", flush=True)

    # K9 and K10 at a 5-D UNet site and the VAE's 256x256 map viewed as (16, 16, 4096, 128)
    errs, errs10 = [], []
    for label, shape, silu in [("5-D ds1 (2,16,32,32,320) silu", (2, 16, 32, 32, 320), True),
                               ("5-D ds1 (2,16,32,32,320)", (2, 16, 32, 32, 320), False),
                               ("VAE 256^2 view (16,16,4096,128) silu", (16, 16, 4096, 128), True)]:
        x = randn(*shape, scale=2.0, mean=0.5).to(bf)
        s_, b_ = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        twin = gn.group_norm_temporal_plain(x, s_, b_, silu=silu)
        got = gn.group_norm_fused_temporal(x, s_, b_, silu=silu)
        errs.append(_compare(f"groupnorm_temporal {label}", got, twin))
        if not torch.equal(got, gn.group_norm_fused_temporal(x, s_, b_, silu=silu)):
            _fail(f"groupnorm_temporal {label}: two runs on the same input give different bits")
        errs10.append(_compare(f"groupnorm_big {label}", gn.group_norm_fused_big(x, s_, b_, silu=silu), twin))
    print("  groupnorm_temporal: two runs bit-identical at every site", flush=True)
    sites = {}
    for label, shape in [("5-D ds1 (2,16,32,32,320)", (2, 16, 32, 32, 320)),
                         ("VAE 256^2 view (16,16,4096,128)", (16, 16, 4096, 128))]:
        x = randn(*shape, scale=2.0, mean=0.5).to(bf)
        s_, b_ = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        xn = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2)  # (N, C, positions), the library's layout
        k9 = lambda: gn.group_norm_fused_temporal(x, s_, b_, silu=True)  # noqa: E731
        per_call = _kernels_per_call(k9)
        if sorted(per_call) != ["gn_apply_kernel", "gn_moments_kernel"] or set(per_call.values()) != {1.0}:
            _fail(f"groupnorm_temporal {label}: one call ran {per_call}, not one moments and one apply kernel")
        t9, t10 = _time_kernel(k9), _time_kernel(lambda: gn.group_norm_fused_big(x, s_, b_, silu=True))
        sites[label] = dict(
            k9_ms=t9["ms"], k9_host_ms=t9["host_ms"], k9_device_ms=t9["device_ms"], k9_kernels_per_call=per_call,
            k10_ms=t10["ms"], k10_device_ms=t10["device_ms"],
            twin_ms=_time_ms(lambda: gn.group_norm_temporal_plain(x, s_, b_, silu=True), reps=3),
            library_ms=_time_ms(lambda: torch.nn.functional.group_norm(xn, 32, s_.to(bf), b_.to(bf), 1e-5)),
            **_bound(2 * _nbytes(x) + _nbytes(s_, b_), 0))
        r = sites[label]
        print(f"  time groupnorm {label} + SiLU: K9 {r['k9_ms']:.4f} ms (host {r['k9_host_ms']:.4f}, device "
              f"{_fmt(r['k9_device_ms'])}; kernels per call {per_call}), K10 {r['k10_ms']:.4f} ms (device "
              f"{_fmt(r['k10_device_ms'])}), twin {r['twin_ms']:.4f} ms, library (F.group_norm, no SiLU) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (x read twice: "
              f"{1.5 * r['bound_ms']:.4f})", flush=True)
    main = sites["5-D ds1 (2,16,32,32,320)"]
    common = dict(plain_ms=main["twin_ms"], twin_ms=main["twin_ms"], library_ms=main["library_ms"],
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"], sites=sites)
    res["groupnorm_temporal"] = dict(max_abs_err=max(errs), ms=main["k9_ms"], host_ms=main["k9_host_ms"],
                                     device_ms=main["k9_device_ms"], **common)
    res["groupnorm_big"] = dict(max_abs_err=max(errs10), ms=main["k10_ms"], device_ms=main["k10_device_ms"], **common)

    # K6p: the UNet's ds8 and ds16 levels at batch 2 reading one batch of
    # penalties (the fused-CFG stack of one request), the bench geometry
    F1 = bench_F(dev, b=1)
    errs, sites = [], {}
    for label, (t, h, w, ds, heads) in [("ds8 B=2 pb=1 (2,16384,5,64)", (16, 32, 32, 8, 5)),
                                        ("ds16 B=2 pb=1 (2,4096,10,64)", (16, 16, 16, 16, 10))]:
        hw, nreg = h * w, 4
        lines1 = ef.epipolar_lines(F1, h, w, ds)
        lines = lines1.expand(2, *lines1.shape[1:]).contiguous()
        bk = ef.choose_block_k(hw)
        tiles = ef.kernel_tile_map(lines, t, h, w, ds)
        pen = ef.materialize_penalties(lines1, t, h, w, ds)
        lq = lines.shape[1]
        q = randn(2, lq, heads, 64).to(bf)
        k, v = randn(2, t * hw + nreg, heads, 64).to(bf), randn(2, t * hw + nreg, heads, 64).to(bf)
        kw = dict(t=t, h=h, w=w, downsample=ds, num_registers=nreg)
        run = lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles,  # noqa: E731
                                                  penalties=pen, **kw)
        twin = lambda: ef.epipolar_attention_precomp_plain(q, k, v, pen, t=t, h=h, w=w)  # noqa: E731
        errs.append(_compare(f"epipolar_precomp {label}", run(), twin()))
        pairs = ef.mask_pairs(lines, heads=heads, **kw)
        pen_bytes = ef.visible_penalty_bytes(tiles, t=t, hw=hw, pb=1, block_q=ef.KERNEL_BQ, block_k=ef.KERNEL_BK)
        t6p = _time_kernel(run)
        t6 = _time_kernel(lambda: ef.epipolar_flash_attention(q, k, v, lines, block_k=bk, tile_any=tiles, **kw))
        site = dict(ms=t6p["ms"], host_ms=t6p["host_ms"], device_ms=t6p["device_ms"], in_kernel_k6_ms=t6["ms"],
                    in_kernel_k6_device_ms=t6["device_ms"], penalty_bytes_read=pen_bytes, penalty_bytes=_nbytes(pen),
                    **_bound(_nbytes(q, k, v, q, tiles) + pen_bytes, 4 * 64 * pairs))
        if label.startswith("ds8"):
            site["twin_ms"] = _time_ms(twin, reps=2)
            mask = torch.cat([pen, torch.zeros(1, lq, nreg, dtype=bf, device=dev)], dim=-1)[:, None]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            site["library_ms"] = _time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=3)
            del mask
        sites[label] = site
        print(f"  time epipolar_precomp {label}: kernel {site['ms']:.4f} ms (host {site['host_ms']:.4f}, device "
              f"{_fmt(site['device_ms'])}; in-kernel mask K6 on the same inputs {site['in_kernel_k6_ms']:.4f} ms, "
              f"device {_fmt(site['in_kernel_k6_device_ms'])}), bound {site['bound_ms']:.4f} ms "
              f"({site['bound_by']}; penalty "
              f"subtiles left on {pen_bytes / 2 ** 20:.1f} of {_nbytes(pen) / 2 ** 20:.1f} MiB)", flush=True)
        del pen
        torch.cuda.empty_cache()
    s8 = sites["ds8 B=2 pb=1 (2,16384,5,64)"]
    print(f"  time epipolar_precomp ds8: chunked twin {s8['twin_ms']:.4f} ms, library (SDPA, penalties as a bf16 "
          f"additive mask) {s8['library_ms']:.4f} ms", flush=True)
    res["epipolar_flash_precomp"] = dict(max_abs_err=max(errs), ms=s8["ms"], host_ms=s8["host_ms"],
                                         device_ms=s8["device_ms"], plain_ms=s8["twin_ms"],
                                         twin_ms=s8["twin_ms"], library_ms=s8["library_ms"],
                                         bound_ms=s8["bound_ms"], bound_by=s8["bound_by"], sites=sites)
    res["phase3_launches"] = {n: ops.LAUNCHES[n] for n in ("layernorm", "groupnorm_temporal", "groupnorm_big",
                                                           "epipolar_flash_precomp")}
    if not all(res["phase3_launches"].values()):
        _fail(f"phase 3: a routes kernel never launched: {res['phase3_launches']}")
    for name in ("layernorm", "groupnorm_temporal", "groupnorm_big", "epipolar_flash_precomp"):
        r = res[name]
        print(f"  time {name}: kernel {r['ms']:.4f} ms, plain route = f32 twin {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
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
        by_kernel, total = _profile_by_kernel(step, "camcontext_step_profile.txt",
                                              f"camcontext UNet step batch 1 (event-timed step {step_ms:.3f} ms)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        torch.cuda.synchronize()
        print(f"  camcontext unet step batch 1: host enqueue {host_ms:.3f} ms per call", flush=True)
        parts = _kernels_by_policy(by_kernel)
        k6_ms, k6_calls = parts["K6"]
        print(f"  profile: K6 (flash_fwd_kernel<LineMask>) {k6_ms:.3f} ms over {k6_calls} calls", flush=True)
        gemm = {k: parts[k] for k in ("K4 GEMM 1", "K3 QKV + attention", "K3/K4 out GEMM", "row LN pass")}
        print(f"  profile: K3 + K4 (GEMM core and LN pass) {sum(ms for ms, _ in gemm.values()):.3f} ms: "
              f"{ {k: (round(ms, 3), n) for k, (ms, n) in gemm.items()} }", flush=True)
    return dict(step_ms=step_ms, host_ms=host_ms, profiled_ms=total, k6_profiled_ms=k6_ms,
                k6_profiled_calls=k6_calls, k3_k4_profiled_ms={k: ms for k, (ms, _) in gemm.items()})


def _kernels_by_policy(by_kernel: dict) -> dict:
    """Device time and calls of the Hopper cores' kernels in a profile, by
    kernel: K2 and K6 (the forward body under BoolMask and LineMask), K5
    and K7 (the dq and dk/dv sweeps under each; the shared pre-pass kernel
    is counted apart), and the GEMM core's kernels of K3 and K4 by
    epilogue (the out GEMM and the row LN pass are shared by K3 and K4; the
    LN pass also by K8)."""
    out = {}
    for name, body, policy in (("K2", "flash_fwd_kernel", "BoolMask"), ("K6", "flash_fwd_kernel", "LineMask"),
                               ("K5", "flash_bwd_d", "BoolMask"), ("K7", "flash_bwd_d", "LineMask"),
                               ("pre-pass", "flash_bwd_prepass", ""), ("K4 GEMM 1", "gemm_kernel", "Geglu"),
                               ("K3 QKV + attention", "gemm_kernel", "QkvAttention"),
                               ("K3/K4 out GEMM", "gemm_kernel", "BiasResidual"), ("row LN pass", "ln_rows", "")):
        hits = [v for k, v in by_kernel.items() if body in k and policy in k]
        out[name] = (sum(ms for ms, _ in hits), sum(n for _, n in hits))
    return out


def _profile_by_kernel(fn, out_name: str, title: str, top_n: int = 12):
    """Device time by kernel of one call of `fn` (torch.profiler), written to
    smoke_out/`out_name` and its top entries printed: ({kernel: (ms, calls)},
    total ms)."""
    by_kernel = {}
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            # device-side events only (kernels); a host-side op or autograd
            # node carries its kernels' device time too and would count it twice
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dt = getattr(e, "device_time_total", None)
            if dt is None:
                dt = getattr(e, "cuda_time_total", 0)
            if dt and e.key and "Memcpy" not in e.key:
                ms, n = by_kernel.get(e.key, (0.0, 0))
                by_kernel[e.key] = (ms + dt / 1e3, n + e.count)
    except RuntimeError as err:  # no profiler on this machine: the event times stand alone
        print(f"  profiler: {err}", flush=True)
    total = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    with open(os.path.join(OUT_DIR, out_name), "w") as f:
        f.write(f"{title}: device ms by kernel and calls (sum {total:.3f})\n")
        for key, (ms, n) in top:
            f.write(f"{ms:10.3f} {n:6d}  {key}\n")
    for key, (ms, n) in top[:top_n]:
        print(f"  profile {ms:8.3f} ms {n:5d} calls  {key[:100]}", flush=True)
    print(f"  profile: device time summed over kernels {total:.3f} ms", flush=True)
    return by_kernel, total


def generate(model, make_batch, label: str, device_line: str,
             plan=((1, 11, BENCH_RECIPE), (1, 12, BENCH_RECIPE), (2, 22, BENCH_RECIPE))) -> list:
    """The requests of `plan`, (batch, seed, recipe) each (by default batch
    1, batch 1 again, batch 2 with the bench recipe), through `model.sample`;
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
        for b, seed, recipe in plan:
            batch = make_batch(b, seed)
            g = torch.Generator(device=batch["video"].device).manual_seed(seed + 1)
            torch.cuda.reset_peak_memory_stats()
            peaks.clear()
            for name in real:
                events[name] = []
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with _ClockSampler() as clocks:
                start.record()
                video = model.sample(batch, generator=g, **recipe)
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
            sampler = f"{recipe.get('sampler', 'ddim')} {recipe['ddim_steps']} steps"
            print(f"  {label} request batch={b} seed={seed} {sampler}: out {tuple(video.shape)} finite, "
                  f"std={video.std().item():.4f}, {sec:.3f} s total, {sec / b:.3f} s/video, peak {peak:.2f} GiB, "
                  f"conditioning {cond_s:.3f} s ({cond_s / sec:.3f} of the request) [{device_line}]", flush=True)
            print(f"    split: conditioning {cond_s:.3f} s, {len(unet)} UNet calls {unet_s:.3f} s (min "
                  f"{srt[0]:.1f} / median {srt[len(srt) // 2]:.1f} / max {srt[-1]:.1f} ms; slowest calls "
                  f"{[(i, round(unet[i], 1)) for i in slow]}), decode {dec_s:.3f} s, rest "
                  f"{sec - cond_s - unet_s - dec_s:.3f} s; peak GiB by phase "
                  f"{ {name: round(gib, 2) for name, gib in peaks.items()} }; {clocks.summary}", flush=True)
            out_lines.append(dict(model=label, batch=b, seed=seed, sampler=sampler, seconds=sec, s_per_video=sec / b,
                                  peak_gib=peak,
                                  peak_gib_by_phase=dict(peaks), conditioning_s=cond_s, unet_calls_ms=unet,
                                  decode_s=dec_s, rest_s=sec - cond_s - unet_s - dec_s, clocks=clocks.summary))
    finally:
        for name in real:
            delattr(model, name)
    return out_lines


TRAIN_PATH = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff", "epipolar_flash", "flash_bwd",
              "epipolar_bwd")


class _DropoutOff:
    """Dropout rate 0 in every ResBlock and temporal conv block for the
    block's duration: a training-mode step (block remat on, the path
    `Trainer.fit` runs) that draws no dropout masks."""

    def __init__(self, model):
        from camc2v_tpu_torch.nn.layers import ResBlock, TemporalConvBlock

        self.blocks = [m for m in model.modules() if isinstance(m, (ResBlock, TemporalConvBlock))]
        self.rates = [m.dropout for m in self.blocks]

    def __enter__(self):
        for m in self.blocks:
            m.dropout = 0.0

    def __exit__(self, *exc):
        for m, rate in zip(self.blocks, self.rates):
            m.dropout = rate


def _grad_check(model, state, batch, dev) -> dict:
    """One micro-step's trainable gradients (`trainer.loss_and_grads`, the
    train step's body: CFG dropout, t and noise from one seed, the UNet in
    training mode with block remat, so K2/K6 recompute under the checkpoint
    and feed K5/K7) with the kernels against the same step inside
    `ops.plain_twins()`, ResBlock dropout off."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.nn import unet3d
    from camc2v_tpu_torch.parallel import trainer as TR

    checkpoints = []
    real_checkpoint = unet3d.checkpoint

    def counted(*a, **k):
        checkpoints.append(1)
        return real_checkpoint(*a, **k)

    def grads():
        loss, _, g = TR.loss_and_grads(model, state.params, batch, 5)
        return loss.detach(), torch.cat([x.flatten() for x in g])

    unet3d.checkpoint = counted
    try:
        with _DropoutOff(model):
            ops.reset_launch_counts()
            loss_k, g_k = grads()
            launches = dict(ops.LAUNCHES)
            with ops.plain_twins():
                loss_p, g_p = grads()
    finally:
        unet3d.checkpoint = real_checkpoint
    torch.cuda.synchronize()
    rel = ((g_k - g_p).norm() / g_p.norm()).item()
    by_part, offset = {}, 0
    for name, p in zip(state.names, state.params):
        part = name.split(".")[0]
        d, r = by_part.get(part, (0.0, 0.0))
        gk, gp = g_k[offset:offset + p.numel()], g_p[offset:offset + p.numel()]
        by_part[part] = (d + (gk - gp).square().sum().item(), r + gp.square().sum().item())
        offset += p.numel()
    parts = {k: (d / r) ** 0.5 for k, (d, r) in by_part.items()}
    finite = bool(torch.isfinite(g_k).all())
    print(f"  gradients batch 1, block remat on ({len(checkpoints)} checkpointed blocks over both runs), "
          f"kernels vs plain twins: rel_l2={rel:.3e} tol=5e-2 by part { {k: f'{v:.3e}' for k, v in parts.items()} }, "
          f"loss {loss_k.item():.6f} vs {loss_p.item():.6f}, |g| {g_p.norm().item():.4e}, finite={finite}; "
          f"kernel launches {launches}", flush=True)
    if not checkpoints or launches["flash_bwd"] == 0 or launches["epipolar_bwd"] == 0:
        _fail("train: the gradient check did not run block remat and the backward kernels")
    if not (finite and rel <= 5e-2):
        _fail("train: the gradients with the kernels disagree with the plain twins")
    return dict(rel_l2=rel, rel_l2_by_part=parts, loss_kernels=loss_k.item(), loss_plain=loss_p.item(),
                checkpointed_blocks=len(checkpoints), launches=launches)


def train_phase(dev, device_line: str) -> dict:
    """Phase 7: CamContextI2V-256 training (see the module docstring)."""
    from camc2v_tpu_torch import ops, presets
    from camc2v_tpu_torch.main.harness import Trainer
    from camc2v_tpu_torch.parallel import trainer as TR

    cfg = presets.camcontexti2v_256_train()
    t0 = time.perf_counter()
    model = presets.build_for_training("camcontexti2v_256", seed=4321)
    state = TR.init_train_state(cfg, model)
    trainable = set(state.names)
    named = dict(model.named_parameters())
    n_train = sum(p.numel() for p in state.params)
    frozen_dtypes = sorted({str(p.dtype) for n, p in named.items() if n not in trainable})
    print(f"  built in {time.perf_counter() - t0:.1f} s: {n_train / 1e6:.1f}M trainable fp32 parameters of "
          f"{sum(p.numel() for p in named.values()) / 1e6:.1f}M; frozen dtypes {frozen_dtypes}; resident "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    if any(p.dtype != torch.float32 for p in state.params) or any(
            p.requires_grad for n, p in named.items() if n not in trainable):
        _fail("train: trainable masters must be fp32 and frozen parameters must not require grad")

    grad_check = _grad_check(model, state, camcontext_batch(model, 1, 31, dev), dev)
    torch.cuda.empty_cache()

    frozen_before = {n: p.detach().clone() for n, p in named.items() if n not in trainable}
    train_before = [p.detach().clone() for p in state.params]
    marks: list = []

    def batches(b, n, seed):
        for i in range(n):
            batch = camcontext_batch(model, b, seed + i, dev)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
            yield batch

    runs = {}
    ops.reset_launch_counts()
    for b, steps, seed in [(2, 8, 100), (1, 4, 200)]:
        marks.clear()
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(model, cfg, batches(b, steps, seed), seed=0, log_every_n_steps=1)
        with _ClockSampler() as clocks:
            w0 = time.perf_counter()
            state = trainer.fit(state, max_steps=state.step + steps)
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
        marks.append(end)
        ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(steps)]
        hist = trainer.history
        if len(hist) != steps or not all(np.isfinite([h[k] for h in hist for k in ("loss", "loss_simple",
                                                                                  "grad_norm")])):
            _fail(f"train batch {b}: {len(hist)} logged steps, or a loss / grad norm not finite: {hist}")
        opt_s = [sum(ms[i:i + cfg.accumulate_grad_batches]) / 1e3 for i in range(0, steps, cfg.accumulate_grad_batches)]
        later = sorted(ms[1:])
        runs[b] = dict(micro_step_ms=ms, optimizer_step_s=opt_s, wall_s=wall, samples_per_s=b * steps / wall,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
                       clocks=clocks.summary)
        print(f"  train batch={b}: {steps} micro-steps, ms each {[round(x, 1) for x in ms]} (median after the "
              f"first {later[len(later) // 2]:.1f}), s per optimizer step {[round(x, 3) for x in opt_s]}, "
              f"{b * steps / wall:.3f} samples/s ({wall:.2f} s wall), peak {runs[b]['peak_gib']:.2f} GiB "
              f"[{device_line}]; {clocks.summary}", flush=True)
        print(f"    loss {[round(h['loss'], 5) for h in hist]} grad_norm {[round(h['grad_norm'], 4) for h in hist]}",
              flush=True)
    launches = dict(ops.LAUNCHES)
    print(f"[7 launches] train {launches}", flush=True)
    if state.step != 12 or state.updates != 3 or not all(launches[n] > 0 for n in TRAIN_PATH):
        _fail(f"train: steps {state.step} updates {state.updates}, or a kernel of the path never launched: "
              f"{launches}")
    changed = sum(not torch.equal(p, p0) for p, p0 in zip(state.params, train_before))
    frozen_same = all(torch.equal(named[n], p0) for n, p0 in frozen_before.items())
    print(f"  {changed} of {len(state.params)} trainable tensors changed; frozen bit-identical: {frozen_same}",
          flush=True)
    if changed < len(state.params) // 2 or not frozen_same:
        _fail("train: the optimizer did not move the trainable parameters, or it moved frozen ones")
    del frozen_before, train_before

    split = _train_split(model, state, cfg, dev)
    return dict(device=device_line, trainable_params=n_train, grad_check=grad_check, runs=runs, launches=launches,
                split=split)


def _train_split(model, state, cfg, dev) -> dict:
    """One optimizer step (4 batch-2 micro-steps) of `make_train_step`, the
    step `Trainer.fit` runs, each micro-step split by CUDA events recorded
    around the model's own calls: conditioning (start to `p_losses`: VAE
    encode of T + N frames, CLIP text, CLIP vision + Resampler, camera
    payload, adaptor + zero conv, the t and noise draws), forward + loss
    (`p_losses`), backward (to `apply_gradients`: the gradients and their
    global norm) and the optimizer (`apply_gradients`: accumulation, and on
    the 4th micro-step clip + AdamW); then one more micro-step profiled by
    kernel."""
    from camc2v_tpu_torch.parallel import trainer as TR

    names = ("encode_first_stage", "encode_text", "embed_images", "camera_condition", "latent_condition",
             "p_losses")
    real = {n: getattr(model, n) for n in names}
    real_apply = TR.apply_gradients
    spans: list = [{}]  # per micro-step: name -> [(start, end) events]

    def timed(name, fn):
        def call(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            spans[-1].setdefault(name, []).append((s, e))
            return out
        return call

    step = TR.make_train_step(model, cfg)
    batch = camcontext_batch(model, 2, 300, dev)
    k = cfg.accumulate_grad_batches
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(k + 1)]
    for n in names:
        setattr(model, n, timed(n, real[n]))
    TR.apply_gradients = timed("apply_gradients", real_apply)
    try:
        while state.step % k:  # start at an accumulation window's first micro-step
            step(state, batch, 7)
        spans.clear()
        torch.cuda.reset_peak_memory_stats()
        marks[0].record()
        for i in range(k):
            spans.append({})
            step(state, batch, 7)
            marks[i + 1].record()
        torch.cuda.synchronize()
    finally:
        for n in names:
            delattr(model, n)
        TR.apply_gradients = real_apply
    micro = []
    for i, sp in enumerate(spans):
        [(fs, fe)], [(os_, oe)] = sp["p_losses"], sp["apply_gradients"]
        micro.append(dict(
            total_ms=marks[i].elapsed_time(marks[i + 1]), conditioning_ms=marks[i].elapsed_time(fs),
            forward_loss_ms=fs.elapsed_time(fe), backward_ms=fe.elapsed_time(os_), optimizer_ms=os_.elapsed_time(oe),
            parts_ms={n: sum(a.elapsed_time(b) for a, b in sp.get(n, [])) for n in names[:-1]}))
    out = dict(micro_steps=micro, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    for i, m in enumerate(micro):
        part = m["parts_ms"]
        print(f"  split of batch-2 micro-step {i + 1}/{k} of an optimizer step ({m['total_ms']:.1f} ms): "
              f"conditioning {m['conditioning_ms']:.1f} ms (VAE encode {part['encode_first_stage']:.1f}, CLIP text "
              f"{part['encode_text']:.1f}, CLIP vision + Resampler {part['embed_images']:.1f}, camera payload "
              f"{part['camera_condition']:.1f}, adaptor + zero conv {part['latent_condition']:.1f}), UNet forward + "
              f"loss {m['forward_loss_ms']:.1f} ms, backward + grad norm {m['backward_ms']:.1f} ms, optimizer "
              f"{m['optimizer_ms']:.1f} ms", flush=True)
    print(f"  peak over the optimizer step {out['peak_gib']:.2f} GiB", flush=True)
    by_kernel, prof_total = _profile_by_kernel(lambda: step(state, batch, 8), "train_step_profile.txt",
                                               "CamContextI2V training micro-step batch 2", top_n=16)
    out["profiled_ms"] = prof_total
    out["hopper_kernels_ms"] = _kernels_by_policy(by_kernel)
    print("  profile: the Hopper core's kernels in the micro-step (ms, calls): "
          + ", ".join(f"{k} {ms:.3f}, {n}" for k, (ms, n) in out["hopper_kernels_ms"].items()), flush=True)
    out["profile_top"] = sorted(((k, ms, n) for k, (ms, n) in by_kernel.items()), key=lambda x: -x[1])[:25]
    return out


def _routes_unet_check(model, dev) -> dict:
    """One fused-CFG guided step of a batch-1 CamContextI2V request with the
    routes on: the uncond padded to the context's length (a per-frame
    (B, T, L) key mask), the penalties shared by the stacked batch; the one
    batch-2 UNet call it makes, kernels against `ops.plain_twins()`."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.nn.epipolar import add_precomputed_penalties

    batch = camcontext_batch(model, 1, 51, dev)
    calls = []
    real = model.apply_model

    def record(x, t, cond, fs=None, **kw):
        calls.append((x, t, cond, fs))
        return real(x, t, cond, fs, **kw)

    with torch.no_grad():
        z, cond = model.prepare_batch(batch, prefetch_uncond=True)
        cond["camera"]["epi_prep"] = add_precomputed_penalties(cond["camera"]["epi_prep"], model.config.epipolar,
                                                               model.config.video_length)
        uc = model.build_uncond(cond, 1, (256, 256))
        cond.pop("_uncond", None)
        fn = model.build_guided_fn(cond, uc, model.get_fs(batch), guidance_scale=7.5, guidance_rescale=0.7)
        x = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(52), device=dev)
        model.apply_model = record
        try:
            fn(x, torch.full((1,), 999, device=dev))
        finally:
            del model.apply_model
        if len(calls) != 1 or calls[0][0].shape[0] != 2:
            _fail(f"routes: the guided step made {len(calls)} UNet calls, not one fused batch-2 call")
        x2, t2, c2, fs2 = calls[0]
        prep = c2["camera"]["epi_prep"]
        pen = {ds: e["penalties"] for ds, e in prep.items() if "penalties" in e}
        if not pen or any(p.shape[0] != 1 or prep[ds]["lines"].shape[0] != 2 for ds, p in pen.items()) or \
                tuple(c2["c_crossattn_mask"].shape) != (2, 16, c2["c_crossattn"].shape[1]):
            _fail("routes: the fused batch must share (B, ...) penalties and carry the (2B, T, L) key mask")
        ops.reset_launch_counts()
        got = model.apply_model(x2, t2, c2, fs2)
        launches = dict(ops.LAUNCHES)
        with ops.plain_twins():
            ref = model.apply_model(x2, t2, c2, fs2)
        _rel_check("routes fused-CFG unet call (2,16,32,32,8), penalties shared", got, ref)
        timed = _time_kernel(lambda: model.apply_model(x2, t2, c2, fs2), reps=5)
        step_ms = timed["ms"]
        print(f"  routes fused-CFG UNet call: {step_ms:.3f} ms (host enqueue {timed['host_ms']:.3f} ms, device "
              f"{_fmt(timed['device_ms'])} per call); launches {launches}; penalties "
              f"{ {ds: tuple(p.shape) for ds, p in pen.items()} }", flush=True)
        # each route left out in turn, the others on: what each one moves
        fs = model.get_fs(batch)
        no_pen = dict(c2, camera=dict(c2["camera"], epi_prep={
            ds: {k: v for k, v in e.items() if k != "penalties"} for ds, e in prep.items()}))
        leave_out = {"all on": step_ms}
        for name in ("CAMC2V_LN_FUSED", "CAMC2V_GN_TEMPORAL"):
            with _switch(name, "0"):
                leave_out[f"{name} off"] = _time_ms(lambda: model.apply_model(x2, t2, c2, fs2), reps=3)
        leave_out["no penalties (K6 in the UNet)"] = _time_ms(lambda: model.apply_model(x2, t2, no_pen, fs2), reps=3)
        leave_out["CAMC2V_FUSED_CFG off (two batch-1 calls)"] = _time_ms(
            lambda: (model.apply_model(x, t2[:1], cond, fs), model.apply_model(x, t2[:1], uc, fs)), reps=3)
        print(f"  routes UNet step, each route left out (ms): { {k: round(v, 3) for k, v in leave_out.items()} }",
              flush=True)
        by_kernel, total = _profile_by_kernel(lambda: model.apply_model(x2, t2, c2, fs2), "routes_step_profile.txt",
                                              f"routes fused-CFG UNet call, batch 2 (event-timed {step_ms:.3f} ms)")
        routes_kernels = {name: (sum(ms for k, (ms, _) in by_kernel.items() if re.search(pattern, k)),
                                 sum(n for k, (_, n) in by_kernel.items() if re.search(pattern, k)))
                          for name, pattern in (("K6p", r"flash_fwd_kernel<\d+, hflash::PenaltyMask>"),
                                                ("K6", r"flash_fwd_kernel<\d+, hflash::LineMask>"),
                                                ("K9", r"gn_moments_kernel|gn_apply_kernel"),
                                                ("K8 / row LN pass", r"ln_rows"))}
        print("  profile: the routes' kernels in the call (ms, calls): "
              + ", ".join(f"{k} {ms:.3f}, {n}" for k, (ms, n) in routes_kernels.items()), flush=True)
    for name in ("layernorm", "groupnorm_temporal", "epipolar_flash_precomp", "flash_attention"):
        if launches[name] == 0:
            _fail(f"routes: {name} never launched in the fused UNet call: {launches}")
    return dict(step_ms=step_ms, host_ms=timed["host_ms"], device_ms=timed["device_ms"],
                routes_kernels_ms=routes_kernels, leave_one_out_ms=leave_out, launches=launches,
                rel_l2=((got - ref).norm() / ref.norm()).item(),
                profiled_ms=total, profile_top=sorted(((k, ms, n) for k, (ms, n) in by_kernel.items()),
                                                      key=lambda e: -e[1])[:25])


def routes_phase(dev, device_line: str) -> dict:
    """Phase 8: CamContextI2V-256 generation with every opt-in route on (see
    the module docstring)."""
    from camc2v_tpu_torch import ops, presets
    from camc2v_tpu_torch.models import dynamicrafter as dm

    penalty_bytes = []
    real_add = dm.add_precomputed_penalties

    def counted(prep, *a, **k):
        out = real_add(prep, *a, **k)
        penalty_bytes.append({ds: _nbytes(e["penalties"]) for ds, e in out.items() if "penalties" in e})
        return out

    with _switches("1"):
        model = presets.build("camcontexti2v_256", seed=4321)
        step = _routes_unet_check(model, dev)
        torch.cuda.empty_cache()
        plan = ((1, 61, BENCH_RECIPE), (1, 62, BENCH_RECIPE), (2, 72, BENCH_RECIPE), (1, 63, DPMPP_RECIPE))
        dm.add_precomputed_penalties = counted
        try:
            ops.reset_launch_counts()
            requests = generate(model, lambda b, seed: camcontext_batch(model, b, seed, dev), "camcontexti2v routes",
                                device_line, plan=plan)
            launches = dict(ops.LAUNCHES)
        finally:
            dm.add_precomputed_penalties = real_add
        adaptor_layers = model.config.adaptor.depth
    for req, pb in zip(requests, penalty_bytes):
        req["penalty_bytes"] = pb
    print(f"[8 launches] camcontexti2v routes {launches}; penalties per request (bytes by level) {penalty_bytes}",
          flush=True)
    need = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff", "layernorm", "groupnorm_temporal",
            "epipolar_flash_precomp")
    if not all(launches[n] > 0 for n in need):
        _fail(f"routes: a kernel of the routes path never launched: {launches}")
    if launches["epipolar_flash"] != adaptor_layers * len(plan):
        _fail(f"routes: in-kernel K6 launched {launches['epipolar_flash']} times, not only in the adaptor "
              f"({adaptor_layers} layers x {len(plan)} requests)")
    del model
    torch.cuda.empty_cache()
    return dict(unet_step=step, requests=requests, launches=launches)


# registers a thread of each attention-core kernel takes (`-Xptxas -v`), by
# kernel, policy and padded head dim (D <= 64, <= 128): K2/K5 under BoolMask
# and K6/K7 under LineMask as recorded in PERF.md; a policy's hooks must not
# move them
CORE_REGISTERS = {("flash_fwd_kernel", "BoolMask"): (94, 134), ("flash_bwd_dq_kernel", "BoolMask"): (138, 170),
                  ("flash_bwd_dkv_kernel", "BoolMask"): (168, 197), ("flash_fwd_kernel", "LineMask"): (95, 150),
                  ("flash_bwd_dq_kernel", "LineMask"): (138, 168), ("flash_bwd_dkv_kernel", "LineMask"): (163, 200)}


def _ptxas_registers(log: str) -> dict:
    """{mangled kernel name: registers} from an `-Xptxas -v` log."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = int(m.group(1))
            entry = None
    return out


def _check_core_registers(build) -> dict:
    """Phase 2's check of the attention core: K2/K5/K6/K7 keep their
    registers, and K6p's shared memory and blocks per SM at D = 64 and 128
    (from the runtime: the dynamic shared memory is not in nvcc's report)."""
    import ctypes

    regs = {}
    for name in ("flash_attention", "flash_bwd", "epipolar_flash", "epipolar_bwd", "epipolar_precomp"):
        regs.update(_ptxas_registers((build.BUILD_DIR / f"{name}.log").read_text()))
    found = {}
    for (body, policy), want in list(CORE_REGISTERS.items()) + [(("flash_fwd_kernel", "PenaltyMask"), None)]:
        got = tuple(n for dp in (64, 128) for k, n in regs.items() if body + "ILi" + str(dp) in k and policy in k)
        found[f"{body} {policy}"] = got
        print(f"  registers {body} {policy} (D <= 64, <= 128): {got}" + (f", recorded {want}" if want else ""),
              flush=True)
        if len(got) != 2 or (want is not None and got != want):
            _fail(f"phase 2: {body} under {policy} takes {got} registers, not {want}")
    with torch.no_grad():
        fn = build.function("epipolar_precomp", "epipolar_precomp_occupancy",
                            [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)])
        for d in (64, 128):
            smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
            build.check(fn(d, ctypes.byref(smem), ctypes.byref(blocks)), "epipolar_precomp_occupancy")
            found[f"K6p D={d}"] = dict(smem_bytes=smem.value, blocks_per_sm=blocks.value)
            print(f"  K6p forward (PenaltyMask) D={d}: {smem.value} bytes of shared memory a block, "
                  f"{blocks.value} blocks per SM", flush=True)
            if blocks.value < (2 if d == 64 else 1):
                _fail(f"phase 2: K6p at D={d} fits {blocks.value} blocks per SM")
    return found



def main() -> None:
    if not torch.cuda.is_available():
        _fail("CUDA is not available (this smoke run needs the GPU; there is no CPU fallback)")
    from camc2v_tpu_torch import ops, presets
    from camc2v_tpu_torch.ops import _build

    dev = torch.device("cuda:0")
    device_line = _device_line()
    stack = contextlib.ExitStack()
    stack.enter_context(_switches("0"))  # phases 1-7: the default path
    os.makedirs(OUT_DIR, exist_ok=True)
    print(f"[1 device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)

    secs = _build.build_all()
    print(f"[2 build] {len(_build.KERNELS)} kernel libraries built in {secs:.1f} s", flush=True)
    for name in ("flash_attention", "flash_bwd", "epipolar_flash", "epipolar_bwd", "epipolar_precomp",
                 "temporal_attention", "geglu_ff"):
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()[:160]}", flush=True)
            if any(int(n) for n in re.findall(r"(\d+) bytes spill", line)) or "C7515" in line or "C7512" in line:
                _fail(f"phase 2: {name} spills or serialises a wgmma: {line.strip()}")
    _check_core_registers(_build)

    print("[3 kernels] kernel vs plain twin, bf16", flush=True)
    dc = presets.build("dynamicrafter_256", seed=1234)  # pins the card's numerics before the checks
    cc = presets.build("camcontexti2v_256", seed=4321)
    checks = kernel_checks(dev)
    checks["flash_attention"]["unet_call_sites"] = flash_site_checks(cc, dev)
    for name, found in ff_mha_site_checks(cc, dev).items():
        checks[name]["unet_call_sites"] = found
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], found["max_abs_err"])
    checks.update(backward_checks(dev))
    checks.update(route_kernel_checks(dev))
    torch.cuda.empty_cache()

    print("[4 unet] full-width denoise steps", flush=True)
    unet_check(dc, dev)
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
    cc_launches = dict(ops.LAUNCHES)
    print(f"[6 launches] dynamicrafter {dc_launches}; camcontexti2v {cc_launches}", flush=True)
    dc_path = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff")
    if not all(dc_launches[n] > 0 for n in dc_path) or not all(cc_launches[n] > 0 for n in dc_path + (
            "epipolar_flash",)):
        _fail(f"a kernel of a generation path was never launched: {dc_launches} / {cc_launches}")
    del cc
    torch.cuda.empty_cache()

    print("[7 train] CamContextI2V-256 training, full width", flush=True)
    train = train_phase(dev, device_line)
    launches = train["launches"]
    stack.close()

    print("[8 routes] CamContextI2V-256 with the opt-in routes on (K6p, K8, K9, fused CFG, DPM++(2M))", flush=True)
    routes = routes_phase(dev, device_line)

    with open(os.path.join(OUT_DIR, "chip_smoke_summary.json"), "w") as f:
        json.dump(dict(device=device_line, requests=requests, unet_step=step, launches_dynamicrafter=dc_launches,
                       launches_camcontexti2v=cc_launches, train=train, routes=routes, kernels=checks), f, indent=1)
    sources = {
        "groupnorm": ("camc2v_tpu_torch/csrc/groupnorm.cu", "camc2v_tpu/ops/groupnorm.py:31"),
        "flash_attention": ("camc2v_tpu_torch/csrc/flash_attention.cu", "camc2v_tpu/ops/flash_attention.py:170"),
        # K3 and K4 on the GEMM core csrc/gemm_hopper.cuh, with the LN pass of csrc/layernorm.cuh
        "temporal_attention": ("camc2v_tpu_torch/csrc/temporal_attention.cu",
                               "camc2v_tpu/ops/temporal_attention.py:120"),
        "geglu_ff": ("camc2v_tpu_torch/csrc/geglu_ff.cu", "camc2v_tpu/ops/geglu_ff.py:92"),
        "epipolar_flash": ("camc2v_tpu_torch/csrc/epipolar_flash.cu", "camc2v_tpu/ops/epipolar_flash.py:226"),
        "flash_bwd": ("camc2v_tpu_torch/csrc/flash_bwd.cu", "camc2v_tpu/ops/flash_attention.py:329"),
        "epipolar_bwd": ("camc2v_tpu_torch/csrc/epipolar_bwd.cu", "camc2v_tpu/ops/epipolar_flash.py:666"),
        "epipolar_flash_precomp": ("camc2v_tpu_torch/csrc/epipolar_precomp.cu",
                                   "camc2v_tpu/ops/epipolar_flash.py:370"),
        "layernorm": ("camc2v_tpu_torch/csrc/layernorm.cu", "camc2v_tpu/ops/layernorm.py:29"),
        "groupnorm_temporal": ("camc2v_tpu_torch/csrc/groupnorm_twophase.cu", "camc2v_tpu/ops/groupnorm.py:265"),
        "groupnorm_big": ("camc2v_tpu_torch/csrc/groupnorm_twophase.cu", "camc2v_tpu/ops/groupnorm.py:160"),
    }
    keys = ("max_abs_err", "ms", "plain_ms", "twin_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the routes run (this slice's path) for its kernels, the
    # training run (the earlier slice's path, every K1-K7) for the others;
    # the default CamContextI2V generation run's and the routes run's counts
    # beside them (K10 has no model caller: its launches are phase 3's)
    new = ("epipolar_flash_precomp", "layernorm", "groupnorm_temporal", "groupnorm_big")
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=routes["launches"][name] if name in new else launches[name],
             launches_generation=cc_launches[name], launches_routes=routes["launches"][name],
             **{k: checks[name][k] for k in keys})
        for name, (src, rep) in sources.items()
    ]
    kernels[-1]["launches_phase3"] = checks["phase3_launches"]["groupnorm_big"]
    for k in kernels:
        if k["name"] in ("temporal_attention", "geglu_ff"):
            k["headers"] = ["camc2v_tpu_torch/csrc/gemm_hopper.cuh", "camc2v_tpu_torch/csrc/sm90.cuh",
                            "camc2v_tpu_torch/csrc/layernorm.cuh"]
            k["unet_call_weighted_ms"] = checks[k["name"]]["unet_call_sites"]["weighted_ms"]
    print(device_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
