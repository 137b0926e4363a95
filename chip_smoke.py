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
              pair, per set mask bit for K7). K1 at every GroupNorm site
              of the UNet (4-D per frame with CFG batched, N = 32, and at
              batch 1, N = 16; 5-D temporal at batch 2 and 1; every level)
              and the VAE's 256^2 map: against the twin with SiLU on and
              off, the same bits on a repeat, its kernels per call from the
              profiler (one on the cluster path, statistics and apply on
              the two-launch path), events, host enqueue and device time
              per site beside F.group_norm and the bound
              (smoke_out/groupnorm_sites.json); K8 likewise at the UNet's
              transformer widths and the CLIP towers' (one `ln_rows` per
              call; smoke_out/layernorm_sites.json). K9 (the routes' GroupNorm)
              and K6p (the routes' epipolar attention on penalties): events,
              host enqueue and profiler device time per call beside the twin,
              the library call and the bound; K9 must run exactly its two
              kernels per call (no copy or memset in the profile) and give
              the same bits on two runs; K10 runs K1's plan on the same two
              views: against its twin (K1's), the same bits twice and K1's
              planned kernels per call. The padded context path: K6 and K7
              at the adaptor's geometry (cond + 4 context frames of 32x32,
              the last 2 padded: NaN lines) and K2 and K5 at the UNet's ds1
              image cross-attention with the 2 padded frames' 512 tokens
              masked, each against its twin and against the kernel on the
              unpadded keys (outputs, lse and dq within 4 ulps, the kept
              keys' dk and dv too, the padded keys' dk and dv exactly 0, the
              padded frames' tiles off in the skip map). K1's batch
              invariance: one sample normalised alone and as the first of a
              batch of 4, at the VAE's 256x256x128 site and the UNet's
              32x32x320 site, must be the same bits (printed with the
              plans).
  4. unet     one full-width batch-2B UNet denoise step with the kernels
              against the same step inside `ops.plain_twins()`: DynamiCrafter,
              then CamContextI2V with a real camera payload; the second also
              profiled at batch 1 (device time by kernel, K1's and K3 + K4's
              apart, smoke_out/).
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
  9. train-run the training entry point (`python -m camc2v_tpu_torch.main.
              train`, called in this process) on configs/models/
              camcontexti2v_256.yaml at full width: a synthetic RealEstate10K
              tree under smoke_out/train_run (.npz clips at 360x640, moving
              camera poses, captions, a synthetic BPE merges table), the
              yaml's data path (1-4 context frames padded to 4, batch 2,
              accumulation 4) with dotlist overrides for the paths and the
              logging (CSV, every step; validation and a checkpoint every 4
              micro-steps); 8 micro-steps, then `--continue` to 12. Fails
              unless the losses are finite, the resumed run starts at step 8
              with its restored state bit-equal to the saved run's, the CSV
              holds the 12 steps' rows, every K1-K7 launches (counts zeroed
              before the first run, read after the second), and a padded
              batch (2 of 4 slots) and its unpadded twin, kernels on, give
              the loss within relative 1e-3 and c_concat's latent branch on
              the same latents within relative L2 1e-3 (c_concat end to end
              is printed beside the frozen VAE's own batch dependence, the
              same 16 frames encoded beside 2 or 4 context frames, which
              bounds how far it can agree; that dependence layer by layer:
              the relative L2 after conv_in, each down block, the middle
              block and conv_out, the first GroupNorm or conv whose output
              differs and the first above 1e-3; the run fails when a
              GroupNorm is the first). Prints seconds per
              micro-step and optimizer step, samples/s, the data wait's
              share, validation seconds per batch, checkpoint save and
              restore seconds and bytes, and peak memory.
 10. generate-02 CamContextI2V-256 generation as 02_generate_videos.py runs
              it, on the default path: (a) three requests (batch 1 twice,
              then 2) of the bench recipe with camera CFG 1.5 and the cosine
              scheduler (a third, camera-free UNet call a step), s/video,
              UNet calls per step, peak memory and the split; counts zeroed
              just before and read just after, K1-K4 and K6 must launch;
              (b) one guided evaluation at t = 500 with camera CFG, and the
              camera-free pass alone, kernels vs `ops.plain_twins()`: each
              of the evaluation's three UNet calls and the pass within
              relative L2 5e-2 (phase 4's tolerance), the guided output's
              own relative L2 printed (CFG 7.5 scales the calls'
              differences up against it); in the camera-free pass K6 must
              not launch and K3 must; (c) DDIM at batch 1 with
              the conditioning frame 5 pasted and 2 overlap frames: those
              frames equal origin_z0 bit for bit, every value finite; (d)
              `p_sample_loop` through the guided closure over the last 25
              DDPM steps; (e) img2img: `ddim_stochastic_encode` to DDIM step
              12 of 25, then `ddim_decode`; (d) and (e) timed and finite.
The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
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


def _kernels_per_call(fn, expected: dict, reps: int = 10, tries: int = 3) -> dict:
    """{kernel: launches per call} of `reps` calls of `fn` by torch.profiler
    (device events only: kernels, memsets and copies), after a warm-up call;
    the kernel names without their template arguments. The profiler loses a
    kernel's records now and then (seen on unchanged kernels): a count that
    is short of `expected` (no kernel but the expected ones, none above its
    expected count) is taken again, `tries` times at most; any other count
    is returned at once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
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
        if any(v > expected.get(k, 0) for k, v in out.items()) or out == expected:
            break
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


GN_SITES = ([(f"4-D ds{d} N={n}", (n, h, h, c), 1e-5) for n in (32, 16)
             for d, h, c in ((1, 32, 320), (2, 16, 640), (4, 8, 1280), (8, 4, 1280))]
            + [(f"5-D ds{d} B={b}", (b, 16, h, h, c), 1e-6) for b in (2, 1)
               for d, h, c in ((1, 32, 320), (2, 16, 640), (4, 8, 1280), (8, 4, 1280))]
            + [("VAE 256^2", (16, 256, 256, 128), 1e-6)])
GN_KERNELS = {True: {"gn_cluster_kernel": 1.0}, False: {"gn_stats_kernel": 1.0, "gn_norm_apply_kernel": 1.0}}
K9_KERNELS = {"gn_moments_kernel": 1.0, "gn_apply_kernel": 1.0}


def groupnorm_sites(dev, randn, f32n) -> dict:
    """K1 at GN_SITES (see kernel_checks); the (32, 32, 32, 320) site is the
    kernels line's. Sites' numbers in smoke_out/groupnorm_sites.json."""
    from camc2v_tpu_torch.ops import groupnorm as gn
    from camc2v_tpu_torch.ops._gemm import sm_count

    bf = torch.bfloat16
    errs, sites = [], {}
    for label, shape, eps in GN_SITES:
        x = randn(*shape, scale=2.0) + 0.5
        s, b = f32n(shape[-1], scale=0.2, mean=1.0), f32n(shape[-1], scale=0.2)
        n, c = shape[0], shape[-1]
        plan = gn.norm_plan(n, x.numel() // (n * c), c, 2, 32, sm_count(x.device))
        for silu in (True, False):
            kw = dict(num_groups=32, eps=eps, silu=silu)
            got = gn.group_norm_fused(x, s, b, **kw)
            errs.append(_compare(f"groupnorm {label} {shape} silu={silu} ({'cluster' if plan.cluster else 'two'}"
                                 f" x{plan.slices})", got, gn.group_norm_plain(x, s, b, **kw)))
            if not torch.equal(got, gn.group_norm_fused(x, s, b, **kw)):
                _fail(f"groupnorm {label}: two runs on the same input give different bits")
        run = lambda: gn.group_norm_fused(x, s, b, eps=eps, silu=True)  # noqa: E731
        per_call = _kernels_per_call(run, GN_KERNELS[plan.cluster])
        if per_call != GN_KERNELS[plan.cluster]:
            _fail(f"groupnorm {label}: one call ran {per_call}, not {GN_KERNELS[plan.cluster]}")
        t = _time_kernel(run)
        xn = x.reshape(n, -1, c).transpose(1, 2)  # (N, C, positions), the library's layout
        sites[label] = dict(shape=shape, path="cluster" if plan.cluster else "two launches", slices=plan.slices,
                            smem=plan.smem, kernels_per_call=per_call, ms=t["ms"], host_ms=t["host_ms"],
                            device_ms=t["device_ms"],
                            library_ms=_time_ms(lambda: torch.nn.functional.group_norm(xn, 32, s.to(bf), b.to(bf), eps)),
                            **_bound(2 * _nbytes(x) + _nbytes(s, b), 0))
        r = sites[label]
        print(f"  time groupnorm {label} {shape} + SiLU ({r['path']}, {plan.slices} blocks a sample): {r['ms']:.4f} ms "
              f"(host {r['host_ms']:.4f}, device {_fmt(r['device_ms'])}), F.group_norm {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms", flush=True)
    print("  groupnorm: two runs bit-identical and the planned kernels per call at every site", flush=True)
    with open(os.path.join(OUT_DIR, "groupnorm_sites.json"), "w") as f:
        json.dump(sites, f, indent=1)
    main = sites["4-D ds1 N=32"]
    x = randn(*main["shape"])
    s, b = f32n(320, scale=0.2, mean=1.0), f32n(320, scale=0.2)
    plain = _time_ms(lambda: gn.group_norm_plain(x, s, b, silu=True))
    return dict(max_abs_err=max(errs), ms=main["ms"], host_ms=main["host_ms"], device_ms=main["device_ms"],
                plain_ms=plain, twin_ms=plain, library_ms=main["library_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], sites=sites)


def k1_batch_invariance(randn, f32n) -> dict:
    """K1 on one sample alone and as the first of a batch of 4, at the VAE's
    (., 256, 256, 128) site and the UNet's (., 32, 32, 320) site: the
    sample's output must be the same bits (`ops/groupnorm.py::norm_plan`
    picks a sample's slices from its own shape, never from the batch's
    size), else the run fails."""
    from camc2v_tpu_torch.ops import groupnorm as gn
    from camc2v_tpu_torch.ops._gemm import sm_count

    out = {}
    for label, shape, eps in (("VAE 256^2", (4, 256, 256, 128), 1e-6), ("UNet 4-D ds1", (4, 32, 32, 320), 1e-5)):
        x = randn(*shape, scale=2.0) + 0.5
        s, b = f32n(shape[-1], scale=0.2, mean=1.0), f32n(shape[-1], scale=0.2)
        alone = gn.group_norm_fused(x[:1].contiguous(), s, b, num_groups=32, eps=eps, silu=True)
        batched = gn.group_norm_fused(x, s, b, num_groups=32, eps=eps, silu=True)[:1]
        rows = x[0].numel() // shape[-1]
        plans = [gn.norm_plan(n, rows, shape[-1], 2, 32, sm_count(x.device))[:2] for n in (1, 4)]
        same = bool(torch.equal(alone, batched))
        diff = (alone.float() - batched.float()).abs()
        out[label] = dict(bit_identical=same, max_abs_diff=diff.max().item(),
                          elements_differing=int((diff > 0).sum()), plans_n1_n4=plans)
        print(f"  groupnorm batch invariance {label}: one sample alone vs first of 4 bit-identical={same}, "
              f"max |diff| {out[label]['max_abs_diff']:.3e} on {out[label]['elements_differing']} of "
              f"{alone.numel()} elements; plan (cluster, slices) at n=1 {plans[0]}, n=4 {plans[1]}", flush=True)
    bad = [label for label, r in out.items() if not r["bit_identical"]]
    if bad:
        _fail(f"groupnorm: a sample normalised alone and in a batch of 4 differs at {bad}")
    return out


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

    # K1 at every GroupNorm site of the UNet (4-D per frame with CFG batched,
    # N = 32, and at batch 1, N = 16; 5-D temporal at batch 2 and 1, every
    # level) and the VAE decoder's 256^2 map: against the twin (SiLU on and
    # off), the same bits twice, the kernels of one call from the profiler
    # (one on the cluster path, statistics and apply on the other), times
    res["groupnorm"] = groupnorm_sites(dev, randn, f32n)
    res["groupnorm"]["batch_invariance"] = k1_batch_invariance(randn, f32n)

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


def _exact_zero(name: str, t: torch.Tensor) -> None:
    torch.cuda.synchronize()
    if t.numel() and t.abs().max().item() != 0:
        _fail(f"{name}: the padded keys' gradient is not exactly 0 (max |value| {t.abs().max().item():.3e})")


@torch.no_grad()
def padded_context_checks(dev) -> dict:
    """The training path's padded context slots (1-4 context frames padded to
    4, `cond_frames_valid`): K6 and K7 at the adaptor's geometry (16 frames x
    1024 queries over the cond frame and 4 context frames of 32 x 32, 2
    registers, batch 2) with NaN lines for the last 2 context frames, and K2
    and K5 at the UNet's ds1 image cross-attention of a batch-2 micro-step
    (32 x 1024 queries, 5 heads, over 5 frames x 256 image tokens) with the 2
    padded frames' tokens masked. Each against its twin (4 bf16 ulps), and
    against the same kernel on the unpadded keys: the padded keys get exactly
    zero weight, so the outputs and dq agree within 4 ulps, dk and dv of the
    kept keys too, and the padded keys' dk and dv are exactly 0. The padded
    frames' tiles must be off in K6/K7's skip map."""
    from camc2v_tpu_torch.camera import geometry as G
    from camc2v_tpu_torch.ops import epipolar_flash as ef
    from camc2v_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(9)
    randn = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    errs = {"epipolar_flash": [], "epipolar_bwd": [], "flash_attention": [], "flash_bwd": []}

    # K6, K7: the adaptor over [cond | 4 context frames], the last 2 padded
    t, h, w, ds, nreg, heads, hw, kept = 5, 32, 32, 8, 2, 8, 1024, 3
    cam = bench_camera(2, dev, n_ctx=4)
    F = G.conditional_fundamental(cam["camera_intrinsics"], cam["RT"], cam["RT_cond"],
                                  torch.zeros(2, dtype=torch.long, device=dev))
    valid = torch.arange(t, device=dev) < kept
    lines = torch.where(valid[None, None, :, None], ef.epipolar_lines(F, h, w, ds), torch.nan)
    tiles = ef.kernel_tile_map(lines, t, h, w, ds)
    if tiles[..., kept * hw // ef.KERNEL_BK:t * hw // ef.KERNEL_BK].any():
        _fail("padded context: a padded frame's tile is on in the skip map")
    lq = lines.shape[1]
    q, dout = randn(2, lq, heads, 64), randn(2, lq, heads, 64)
    k, v = randn(2, t * hw + nreg, heads, 64), randn(2, t * hw + nreg, heads, 64)
    keep = torch.cat([torch.arange(kept * hw, device=dev), torch.arange(t * hw, t * hw + nreg, device=dev)])
    ku, vu, lines_u = k[:, keep].contiguous(), v[:, keep].contiguous(), lines[:, :, :kept].contiguous()
    tiles_u = ef.kernel_tile_map(lines_u, kept, h, w, ds)
    kw = dict(h=h, w=w, downsample=ds, num_registers=nreg, scale=0.125)
    geom = dict(kw, t=t, block_q=ef.BLOCK_Q, block_k=ef.BLOCK_K)
    geom_u = dict(geom, t=kept)
    out, lse = ef._launch_fwd(q, k, v, lines, tiles, geom, want_lse=True)
    out_t, lse_t = ef.epipolar_attention_plain(q, k, v, lines, t=t, return_lse=True, **kw)
    out_u, lse_u = ef._launch_fwd(q, ku, vu, lines_u, tiles_u, geom_u, want_lse=True)
    errs["epipolar_flash"] += [
        _compare("padded epipolar adaptor (2,16384,8,64) over 5 frames, 2 padded: out vs twin", out, out_t),
        _compare_lse("padded epipolar lse vs twin", lse, lse_t),
        _compare("padded epipolar out vs the kernel on the unpadded keys", out, out_u),
        _compare_lse("padded epipolar lse vs the kernel on the unpadded keys", lse, lse_u)]
    d = ef.epipolar_flash_bwd(q, k, v, lines, tiles, out, lse, dout, geom)
    d_t = ef.epipolar_bwd_plain(q, k, v, lines, out, lse, dout, t=t, **kw)
    d_u = ef.epipolar_flash_bwd(q, ku, vu, lines_u, tiles_u, out_u, lse_u, dout, geom_u)
    errs["epipolar_bwd"] += [
        _bwd_compare("padded epipolar_bwd vs twin", d, d_t),
        _compare("padded epipolar_bwd dq vs the kernel on the unpadded keys", d[0], d_u[0]),
        _compare("padded epipolar_bwd dk (kept keys) vs unpadded", d[1][:, keep], d_u[1]),
        _compare("padded epipolar_bwd dv (kept keys) vs unpadded", d[2][:, keep], d_u[2])]
    _exact_zero("padded epipolar_bwd dk", d[1][:, kept * hw:t * hw])
    _exact_zero("padded epipolar_bwd dv", d[2][:, kept * hw:t * hw])
    del q, k, v, dout, out, lse, d, d_t, d_u, out_t, lse_t
    torch.cuda.empty_cache()

    # K2, K5: the UNet's ds1 image cross-attention over [cond | 4 context] x 256 tokens, 2 frames padded
    bt, lq, heads, l_tok, n_tok = 32, 1024, 5, 256, 5
    lk, lk_u = n_tok * l_tok, kept * l_tok
    q, dout = randn(bt, lq, heads, 64), randn(bt, lq, heads, 64)
    k, v = randn(bt, lk, heads, 64), randn(bt, lk, heads, 64)
    mask = (torch.arange(lk, device=dev) < lk_u)[None, None].expand(bt, lq, lk)
    out, lse = fa._launch_fwd(q, k, v, mask, 0.125, want_lse=True)
    out_t, lse_t = fa.flash_fwd_plain(q, k, v, mask, 0.125)
    ku, vu = k[:, :lk_u].contiguous(), v[:, :lk_u].contiguous()
    out_u, lse_u = fa._launch_fwd(q, ku, vu, None, 0.125, want_lse=True)
    errs["flash_attention"] += [
        _compare("padded image cross-attention (32,1024,5,64) over 1280, 512 masked: out vs twin", out, out_t),
        _compare_lse("padded image cross-attention lse vs twin", lse, lse_t),
        _compare("padded image cross-attention out vs the kernel on the 768 unpadded keys", out, out_u),
        _compare_lse("padded image cross-attention lse vs unpadded", lse, lse_u)]
    d = fa.flash_bwd(q, k, v, mask, out, lse, dout, 0.125)
    d_t = fa.flash_bwd_plain(q, k, v, mask, out, lse, dout, 0.125)
    d_u = fa.flash_bwd(q, ku, vu, None, out_u, lse_u, dout, 0.125)
    errs["flash_bwd"] += [
        _bwd_compare("padded flash_bwd vs twin", d, d_t),
        _compare("padded flash_bwd dq vs the kernel on the unpadded keys", d[0], d_u[0]),
        _compare("padded flash_bwd dk (kept keys) vs unpadded", d[1][:, :lk_u], d_u[1]),
        _compare("padded flash_bwd dv (kept keys) vs unpadded", d[2][:, :lk_u], d_u[2])]
    _exact_zero("padded flash_bwd dk", d[1][:, lk_u:])
    _exact_zero("padded flash_bwd dv", d[2][:, lk_u:])
    return {name: max(e) for name, e in errs.items()}


@torch.no_grad()
def route_kernel_checks(dev) -> dict:
    """K8, K9, K10 and K6p, the opt-in routes' kernels, against their plain
    twins at the routes path's shapes, timed beside the twin (which is also
    the seam's plain route), the library call and the bound."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.ops import epipolar_flash as ef
    from camc2v_tpu_torch.ops import groupnorm as gn
    from camc2v_tpu_torch.ops import layernorm as ln
    from camc2v_tpu_torch.ops._gemm import sm_count

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    randn = lambda *s, scale=1.0, mean=0.0: (torch.randn(*s, generator=g, device=dev) * scale + mean)  # noqa: E731
    res = {}

    # K8 at the UNet's transformer widths and the CLIP towers': against the
    # twin, the same bits twice, one kernel per call, times
    errs, sites = [], {}
    for label, shape in [("UNet ds1 (32768, 320)", (32768, 320)), ("UNet ds2 (8192, 640)", (8192, 640)),
                         ("UNet ds4 (2048, 1280)", (2048, 1280)), ("CLIP vision (1028, 1280)", (1028, 1280)),
                         ("CLIP text (154, 1024)", (154, 1024))]:
        x = randn(*shape, scale=1.5, mean=0.3).to(bf)
        s_, b_ = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        got = ln.layer_norm_fused(x, s_, b_)
        errs.append(_compare(f"layernorm {label}", got, ln.layer_norm_plain(x, s_, b_)))
        if not torch.equal(got, ln.layer_norm_fused(x, s_, b_)):
            _fail(f"layernorm {label}: two runs on the same input give different bits")
        per_call = _kernels_per_call(lambda: ln.layer_norm_fused(x, s_, b_), {"ln_rows": 1.0})
        if per_call != {"ln_rows": 1.0}:
            _fail(f"layernorm {label}: one call ran {per_call}, not one ln_rows")
        t = _time_kernel(lambda: ln.layer_norm_fused(x, s_, b_))
        sites[label] = dict(ms=t["ms"], host_ms=t["host_ms"], device_ms=t["device_ms"], lanes=ln.ln_plan(shape[-1], 2).lanes,
                            library_ms=_time_ms(lambda: torch.nn.functional.layer_norm(x, (shape[-1],), s_.to(bf),
                                                                                       b_.to(bf), 1e-5)),
                            **_bound(2 * _nbytes(x) + _nbytes(s_, b_), 0))
        r = sites[label]
        print(f"  time layernorm {label}: {r['ms']:.4f} ms (host {r['host_ms']:.4f}, device {_fmt(r['device_ms'])}; "
              f"{r['lanes']} lanes a row), F.layer_norm {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms",
              flush=True)
    with open(os.path.join(OUT_DIR, "layernorm_sites.json"), "w") as f:
        json.dump(sites, f, indent=1)
    x = randn(32768, 320, scale=1.5, mean=0.3).to(bf)
    s_, b_ = randn(320, scale=0.2, mean=1.0), randn(320, scale=0.2)
    plain = _time_ms(lambda: ln.layer_norm_plain(x, s_, b_))
    default = _time_ms(lambda: torch.nn.functional.layer_norm(x.float(), (320,), s_, b_, 1e-5).to(bf))
    main = sites["UNet ds1 (32768, 320)"]
    res["layernorm"] = dict(max_abs_err=max(errs), ms=main["ms"], host_ms=main["host_ms"], device_ms=main["device_ms"],
                            plain_ms=plain, twin_ms=plain, library_ms=main["library_ms"], default_route_ms=default,
                            bound_ms=main["bound_ms"], bound_by=main["bound_by"], sites=sites)

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
        got10 = gn.group_norm_fused_big(x, s_, b_, silu=silu)
        errs10.append(_compare(f"groupnorm_big {label} (K1's plan) vs its twin", got10,
                               gn.group_norm_plain(x, s_, b_, silu=silu)))
        if not torch.equal(got10, gn.group_norm_fused_big(x, s_, b_, silu=silu)):
            _fail(f"groupnorm_big {label}: two runs on the same input give different bits")
    print("  groupnorm_temporal, groupnorm_big: two runs bit-identical at every site", flush=True)
    sites = {}
    for label, shape in [("5-D ds1 (2,16,32,32,320)", (2, 16, 32, 32, 320)),
                         ("VAE 256^2 view (16,16,4096,128)", (16, 16, 4096, 128))]:
        x = randn(*shape, scale=2.0, mean=0.5).to(bf)
        s_, b_ = randn(shape[-1], scale=0.2, mean=1.0), randn(shape[-1], scale=0.2)
        xn = x.reshape(shape[0], -1, shape[-1]).transpose(1, 2)  # (N, C, positions), the library's layout
        k9 = lambda: gn.group_norm_fused_temporal(x, s_, b_, silu=True)  # noqa: E731
        per_call = _kernels_per_call(k9, K9_KERNELS)
        if per_call != K9_KERNELS:
            _fail(f"groupnorm_temporal {label}: one call ran {per_call}, not one moments and one apply kernel")
        k10 = lambda: gn.group_norm_fused_big(x, s_, b_, silu=True)  # noqa: E731
        plan = gn.norm_plan(shape[0], x.numel() // (shape[0] * shape[-1]), shape[-1], 2, 32, sm_count(x.device))
        per_call10 = _kernels_per_call(k10, GN_KERNELS[plan.cluster])
        if per_call10 != GN_KERNELS[plan.cluster]:
            _fail(f"groupnorm_big {label}: one call ran {per_call10}, not K1's planned {GN_KERNELS[plan.cluster]}")
        t9, t10 = _time_kernel(k9), _time_kernel(k10)
        sites[label] = dict(
            k9_ms=t9["ms"], k9_host_ms=t9["host_ms"], k9_device_ms=t9["device_ms"], k9_kernels_per_call=per_call,
            k10_ms=t10["ms"], k10_host_ms=t10["host_ms"], k10_device_ms=t10["device_ms"],
            k10_kernels_per_call=per_call10, k10_path="cluster" if plan.cluster else "two launches",
            k10_slices=plan.slices,
            twin_ms=_time_ms(lambda: gn.group_norm_temporal_plain(x, s_, b_, silu=True), reps=3),
            k10_twin_ms=_time_ms(lambda: gn.group_norm_plain(x, s_, b_, silu=True), reps=3),
            library_ms=_time_ms(lambda: torch.nn.functional.group_norm(xn, 32, s_.to(bf), b_.to(bf), 1e-5)),
            **_bound(2 * _nbytes(x) + _nbytes(s_, b_), 0))
        r = sites[label]
        print(f"  time groupnorm {label} + SiLU: K9 {r['k9_ms']:.4f} ms (host {r['k9_host_ms']:.4f}, device "
              f"{_fmt(r['k9_device_ms'])}; kernels per call {per_call}), K10 on K1's plan {r['k10_ms']:.4f} ms (host "
              f"{r['k10_host_ms']:.4f}, device {_fmt(r['k10_device_ms'])}; {r['k10_path']} x{r['k10_slices']}, "
              f"kernels per call {per_call10}), twin {r['twin_ms']:.4f} ms, library (F.group_norm, no SiLU) "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms (x read twice: "
              f"{1.5 * r['bound_ms']:.4f})", flush=True)
    main = sites["5-D ds1 (2,16,32,32,320)"]
    common = dict(plain_ms=main["twin_ms"], twin_ms=main["twin_ms"], library_ms=main["library_ms"],
                  bound_ms=main["bound_ms"], bound_by=main["bound_by"], sites=sites)
    res["groupnorm_temporal"] = dict(max_abs_err=max(errs), ms=main["k9_ms"], host_ms=main["k9_host_ms"],
                                     device_ms=main["k9_device_ms"], **common)
    res["groupnorm_big"] = dict(max_abs_err=max(errs10), ms=main["k10_ms"], host_ms=main["k10_host_ms"],
                                device_ms=main["k10_device_ms"],
                                **dict(common, plain_ms=main["k10_twin_ms"], twin_ms=main["k10_twin_ms"]))

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
        k1 = {k: parts[k] for k in ("K1 cluster", "K1 statistics", "K1 apply")}
        print(f"  profile: K1 {sum(ms for ms, _ in k1.values()):.3f} ms: "
              f"{ {k: (round(ms, 3), n) for k, (ms, n) in k1.items()} }", flush=True)
    return dict(step_ms=step_ms, host_ms=host_ms, profiled_ms=total, k6_profiled_ms=k6_ms,
                k6_profiled_calls=k6_calls, k3_k4_profiled_ms={k: ms for k, (ms, _) in gemm.items()},
                k1_profiled_ms={k: ms for k, (ms, _) in k1.items()})


def _kernels_by_policy(by_kernel: dict) -> dict:
    """Device time and calls of the Hopper cores' kernels in a profile, by
    kernel: K2 and K6 (the forward body under BoolMask and LineMask), K5
    and K7 (the dq and dk/dv sweeps under each; the shared pre-pass kernel
    is counted apart), and the GEMM core's kernels of K3 and K4 by
    epilogue (the out GEMM and the row LN pass are shared by K3 and K4; the
    LN pass also by K8); K1's three kernels (one launch on the cluster path,
    statistics and apply on the other)."""
    out = {}
    for name, body, policy in (("K2", "flash_fwd_kernel", "BoolMask"), ("K6", "flash_fwd_kernel", "LineMask"),
                               ("K5", "flash_bwd_d", "BoolMask"), ("K7", "flash_bwd_d", "LineMask"),
                               ("pre-pass", "flash_bwd_prepass", ""), ("K4 GEMM 1", "gemm_kernel", "Geglu"),
                               ("K3 QKV + attention", "gemm_kernel", "QkvAttention"),
                               ("K3/K4 out GEMM", "gemm_kernel", "BiasResidual"), ("row LN pass", "ln_rows", ""),
                               ("K1 cluster", "gn_cluster_kernel", ""), ("K1 statistics", "gn_stats_kernel", ""),
                               ("K1 apply", "gn_norm_apply_kernel", "")):
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
            fn(x, torch.full((1,), 999, device=dev), 999)
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


TRAIN_RUN_DIR = os.path.join(OUT_DIR, "train_run")
RE10K_FRAMES = 48  # frames of a synthetic clip (the flagship's stride of 1-10 over 16 frames shrinks to fit)
RE10K_HW = (360, 640)  # RealEstate10K's own frame size
MERGES = ["#version: 0.2", "h e", "l l", "he ll", "hell o</w>", "r o", "ro o", "roo m</w>", "w i", "n d",
          "wi nd", "o w</w>", "wind ow</w>"]


def write_re10k_tree(root: str, names, seed: int) -> dict:
    """A synthetic RealEstate10K split under `root`: `.npz` clips of
    RE10K_FRAMES frames at 360 x 640 (a smooth pattern the camera pans
    across), pose files of a camera moving forward and sideways while it
    turns (RealEstate10K's format: url, then per frame timestamp, normalised
    fx fy cx cy, k1 k2 and the 3 x 4 w2c rows), a list and captions."""
    rng = np.random.default_rng(seed)
    for sub in ("clips", "meta"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = RE10K_HW
    yy, xx = np.mgrid[0:h, 0:w + 4 * RE10K_FRAMES].astype(np.float32)
    for j, name in enumerate(names):
        phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
        base = (127.5 + 120 * np.sin(xx[..., None] / (23 + 7 * j) + yy[..., None] / 31 + phase)).astype(np.uint8)
        frames = np.stack([base[:, 4 * i:4 * i + w] for i in range(RE10K_FRAMES)])
        np.savez(os.path.join(root, "clips", f"{name}.npz"), frames=frames, fps=30.0)
        with open(os.path.join(root, "meta", f"{name}.txt"), "w") as f:
            f.write("https://www.youtube.com/watch?v=synthetic\n")
            for i in range(RE10K_FRAMES):
                a = 0.004 * i + 0.01 * j
                rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                pose = np.hstack([rot, [[-0.01 * i], [0.002 * j], [-0.03 * i]]]).reshape(-1)
                f.write(" ".join(f"{v:.6f}" for v in [33366 * i, 0.48, 0.85, 0.5, 0.5, 0.0, 0.0, *pose]) + "\n")
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    with open(os.path.join(root, "captions.json"), "w") as f:
        json.dump({f"{n}.mp4": [f"a room with a window {n}"] for n in names}, f)
    return {"data_dir": os.path.join(root, "clips"), "meta_path": os.path.join(root, "meta"),
            "meta_list": os.path.join(root, "list.txt"), "caption_file": os.path.join(root, "captions.json"),
            "video_suffix": ".npz"}


def _state_snapshot(state) -> dict:
    """A CPU copy of what a checkpoint holds of `state`."""
    from camc2v_tpu_torch.utils import checkpoint as CK

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    return cpu(CK.state_dict(state))


def _bit_equal(a, b, path="state") -> list:
    """The paths where two snapshots differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor):
        bits = lambda t: t.reshape(-1).view(torch.uint8) if t.is_floating_point() else t  # noqa: E731
        return [] if isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and \
            torch.equal(bits(a), bits(b)) else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [path]
        return [p for k in a for p in _bit_equal(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _bit_equal(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def _pad_context(batch: dict, nmax: int) -> dict:
    """`batch` with its context frames padded to `nmax` slots (zero frames,
    identity poses) and `cond_frames_valid`, as the data path's collate pads."""
    out = dict(batch)
    cf, rt = batch["cond_frames"], batch["RT_cond"]
    b, n = cf.shape[:2]
    out["cond_frames"] = torch.cat([cf, cf.new_zeros(b, nmax - n, *cf.shape[2:])], dim=1)
    out["RT_cond"] = torch.cat([rt, torch.eye(4, device=rt.device).expand(b, nmax - n, 4, 4)], dim=1)
    out["cond_frames_valid"] = (torch.arange(nmax, device=cf.device) < n).expand(b, nmax)
    return out


def vae_batch_layers(vae, frames_a, frames_b, shared: int) -> dict:
    """The VAE encoder's layer-by-layer dependence on its batch: frames_a and
    frames_b hold the same first `shared` frames beside other frames; every
    GroupNorm, conv and block output on those frames is compared between the
    two encodes (relative L2). Up to the first leaf layer whose output
    differs, every input on the shared frames is the same bits, so that
    layer's own result depends on the batch. Returns the rows in order, the
    first leaf that differs at all and the first leaf above 1e-3."""
    from camc2v_tpu_torch.nn.layers import Conv, GroupNorm32
    from camc2v_tpu_torch.nn.vae import AEAttnBlock, AEResnetBlock

    kinds = {GroupNorm32: "GroupNorm (K1)", Conv: "conv (cuDNN)", AEResnetBlock: "block", AEAttnBlock: "block"}
    mods = [(n, m, kinds[type(m)]) for n, m in vae.named_modules() if type(m) in kinds and not n.startswith("decoder")]
    saved, rows = {}, []

    def keep(name):
        def hook(_m, _i, o):
            saved[name] = o[:shared].clone()
        return hook

    def compare(name, kind):
        def hook(_m, _i, o):
            a = saved.pop(name).float()
            rows.append(dict(layer=name, kind=kind, rel_l2=((o[:shared].float() - a).norm() / a.norm()).item()))
        return hook

    for frames, make in ((frames_a, lambda n, k: keep(n)), (frames_b, compare)):
        handles = [m.register_forward_hook(make(n, k)) for n, m, k in mods]
        try:
            vae.encode(frames)
        finally:
            for h in handles:
                h.remove()
    leaves = [r for r in rows if r["kind"] != "block"]
    first = next((r for r in leaves if r["rel_l2"] > 0), None)
    first_1e3 = next((r for r in leaves if r["rel_l2"] > 1e-3), None)
    top = [r for r in rows if r["layer"].count(".") == 1 or r["layer"] == "quant_conv"]
    print(f"  VAE encoder beside 2 vs 4 context frames, the same {shared} frames, rel_l2 after each layer: "
          + ", ".join(f"{r['layer'].split('.', 1)[-1]} {r['rel_l2']:.2e}" for r in top), flush=True)
    print(f"  VAE batch dependence: first layer whose output differs {first}; first above 1e-3 {first_1e3}",
          flush=True)
    return dict(top_layers=top, first_differing=first, first_above_1e3=first_1e3)


def train_run_phase(dev, device_line: str) -> dict:
    """Phase 9: the training entry point on the flagship yaml (see the
    module docstring)."""
    from camc2v_tpu_torch import ops
    from camc2v_tpu_torch.main import train
    from camc2v_tpu_torch.main.callbacks import Callback

    shutil.rmtree(TRAIN_RUN_DIR, ignore_errors=True)
    data_root = os.path.join(TRAIN_RUN_DIR, "re10k")
    t0 = time.perf_counter()
    splits = {"train": write_re10k_tree(os.path.join(data_root, "train"), [f"train{i}" for i in range(4)], 1),
              "validation": write_re10k_tree(os.path.join(data_root, "test"), ["test0", "test1"], 2)}
    merges = os.path.join(data_root, "merges.txt")
    with open(merges, "w") as f:
        f.write("\n".join(MERGES) + "\n")
    print(f"  synthetic RealEstate10K: 4 train and 2 validation clips of {RE10K_FRAMES} frames at "
          f"{RE10K_HW[0]}x{RE10K_HW[1]} written in {time.perf_counter() - t0:.1f} s", flush=True)
    argv = ["--config", "configs/models/camcontexti2v_256.yaml", "--name", "flagship", "--logdir", TRAIN_RUN_DIR,
            "--bpe_path", merges, "--seed", "4321"]
    argv += [f"data.params.{split}.params.{k}={v}" for split, kv in splits.items() for k, v in kv.items()]
    argv += ["data.params.validation_max_n_samples=2", "lightning.trainer.val_check_interval=4",
             "lightning.trainer.limit_val_batches=1", "lightning.trainer.log_every_n_steps=1", "lightning.logger=csv",
             "lightning.callbacks.metrics_over_trainsteps_checkpoint.params.every_n_train_steps=4"]

    class Meter(Callback):
        """Host time of each micro-step (metrics reach the host every step,
        so each step ends synchronised) and its data wait: from asking the
        loader for the batch until the batch is on the card."""

        def __init__(self):
            self.steps = []

        def on_train_batch_start(self, step):
            self.t0 = time.perf_counter()

        def on_data_loaded(self, step):
            self.t1 = time.perf_counter()

        def on_train_batch_end(self, step, state, metrics):
            self.steps.append(dict(step=step, s=time.perf_counter() - self.t0, data_s=self.t1 - self.t0))

    class RestoreCheck(Callback):
        """The resumed state against the saved run's, bit for bit."""

        def __init__(self, saved):
            self.saved, self.diff, self.step = saved, None, None

        def on_fit_start(self, step, state):
            self.step = step
            self.diff = _bit_equal(self.saved, _state_snapshot(state))

    runs = {}
    ops.reset_launch_counts()
    saved = None
    for label, steps, extra in (("run", 8, []), ("resume", 12, ["--continue"])):
        meter = Meter()
        cbs = [meter] + ([RestoreCheck(saved)] if saved is not None else [])
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        trainer, state = train.main(argv + ["--max_steps", str(steps)] + extra, callbacks=cbs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        hist = trainer.history
        if not hist or not all(np.isfinite([h[k] for h in hist for k in ("loss", "grad_norm")])):
            _fail(f"train-run {label}: a loss or grad norm is not finite: {hist}")
        ms = meter.steps
        b = 2
        micro = [m["s"] for m in ms]
        later = sorted(micro[1:]) or micro
        runs[label] = dict(
            wall_s=wall, steps=[m["step"] for m in ms], micro_step_s=micro,
            micro_step_median_after_first_s=later[len(later) // 2],
            optimizer_step_s=[sum(micro[i:i + 4]) for i in range(0, len(micro) - 3, 4)],
            samples_per_s=b * len(micro) / sum(micro), data_wait_s=[m["data_s"] for m in ms],
            data_share=sum(m["data_s"] for m in ms) / sum(micro), losses=[h["loss"] for h in hist],
            grad_norms=[h["grad_norm"] for h in hist], val=trainer.val_history, checkpoints=trainer.checkpoints,
            restore_s=trainer.restore_seconds, resumed_from=trainer.resumed_from,
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        r = runs[label]
        print(f"  train-run {label} to step {state.step}: micro-step s {[round(x, 3) for x in micro]} (median after "
              f"the first {r['micro_step_median_after_first_s']:.3f}), s per optimizer step "
              f"{[round(x, 3) for x in r['optimizer_step_s']]}, {r['samples_per_s']:.3f} samples/s, data wait "
              f"{[round(m['data_s'], 4) for m in ms]} s ({100 * r['data_share']:.2f}% of the micro-steps), validation "
              f"{[(v['step'], round(v['seconds'] / v['batches'], 3)) for v in trainer.val_history]} (step, s per "
              f"batch), checkpoints {[(c['step'], c['bytes'], round(c['seconds'], 3)) for c in trainer.checkpoints]}"
              f" (step, bytes, s), restore {r['restore_s']} s, peak {r['peak_gib']:.2f} GiB, {wall:.1f} s in all "
              f"with the model's build [{device_line}]", flush=True)
        print(f"    loss {[round(x, 5) for x in r['losses']]} grad_norm {[round(x, 4) for x in r['grad_norms']]}",
              flush=True)
        if label == "run":
            if state.step != 8 or state.updates != 2 or [c["step"] for c in trainer.checkpoints] != [4, 8] or \
                    [v["step"] for v in trainer.val_history] != [4, 8]:
                _fail(f"train-run: step {state.step} updates {state.updates}, checkpoints {trainer.checkpoints}, "
                      f"validations {trainer.val_history}")
            saved = _state_snapshot(state)
        else:
            check = cbs[1]
            print(f"  train-run resumed at step {check.step} (trainer: {trainer.resumed_from}); restored state "
                  f"bit-equal to the saved run's: {not check.diff} {check.diff[:5]}", flush=True)
            if check.step != 8 or trainer.resumed_from != 8 or check.diff or state.step != 12 or \
                    state.updates != 3 or ms[0]["step"] != 9:
                _fail(f"train-run: the resumed run started at {check.step} or its state differs: {check.diff[:5]}")
            model = trainer.model
        del trainer, state
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict(ops.LAUNCHES)
    print(f"[9 launches] train-run {launches}", flush=True)
    if not all(launches[n] > 0 for n in TRAIN_PATH):
        _fail(f"train-run: a kernel of the path never launched: {launches}")
    with open(os.path.join(TRAIN_RUN_DIR, "flagship", "logs", "metrics.csv")) as f:
        rows = [line for line in f.read().splitlines() if line]
    print(f"  metrics.csv: {len(rows) - 1} rows under one header: {rows[0]}", flush=True)
    if rows[0].split(",")[0] != "step" or [int(r.split(",")[0]) for r in rows[1:]] != list(range(1, 13)):
        _fail(f"train-run: metrics.csv holds {rows[:3]}... not the 12 steps' rows")

    # a padded batch (2 context frames in 4 slots) against its unpadded twin, kernels on: the loss end to
    # end; c_concat's latent branch on the same latents (the padded slots' NaN lines and skipped tiles);
    # and, reported beside them, c_concat end to end and the frozen VAE's own dependence on its batch (the
    # same 16 frames encoded beside 2 or 4 context frames), which sets how far c_concat end to end can agree
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()  # noqa: E731
    with torch.no_grad():
        batch = camcontext_batch(model, 1, 91, dev)
        padded = _pad_context(batch, 4)
        t = torch.tensor([500], device=dev)
        outs = {}
        for name, bt in (("unpadded", batch), ("padded", padded)):
            z, cond = model.prepare_batch(bt, None, need_full_z=True)
            noise = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev)
            loss, _ = model.p_losses(z, cond, t, noise, model.get_fs(bt), deterministic=True)
            outs[name] = (z, cond, loss.float())
        (zu, cu, lu), (zp, cp, lp) = outs["unpadded"], outs["padded"]
        idx = torch.zeros(1, dtype=torch.long, device=dev)
        z_add = model.encode_first_stage(batch["cond_frames"])
        z_slots = torch.cat([z_add, model.encode_first_stage(padded["cond_frames"][:, 2:])], dim=1)
        branch_u = model.latent_condition(batch, zu[:, 0], z_add, idx)
        branch_p = model.latent_condition(padded, zu[:, 0], z_slots, idx, ctx_valid=padded["cond_frames_valid"])
        video = batch["video"]
        frames = video.shape[1]
        vae_rel = rel(model.encode_first_stage(torch.cat([video, padded["cond_frames"]], 1))[:, :frames],
                      model.encode_first_stage(torch.cat([video, batch["cond_frames"]], 1))[:, :frames])
        vae_layers = vae_batch_layers(model.vae, torch.cat([video, batch["cond_frames"]], 1)[0],
                                      torch.cat([video, padded["cond_frames"]], 1)[0], frames)
    rel_l, rel_b, rel_c = (abs(lp - lu) / abs(lu)).item(), rel(branch_p, branch_u), rel(cp["c_concat"], cu["c_concat"])
    print(f"  padded (2 of 4 slots) vs unpadded, kernels on: loss {lp.item():.6f} vs {lu.item():.6f} rel={rel_l:.3e}, "
          f"c_concat's latent branch on the same latents rel_l2={rel_b:.3e} (tol 1e-3 each); c_concat end to end "
          f"rel_l2={rel_c:.3e}, z rel_l2={rel(zp[:, :frames], zu):.3e}, the same {frames} frames VAE-encoded beside 4 or 2 "
          f"context frames rel_l2={vae_rel:.3e}; image tokens masked {int((~cp['c_crossattn_mask']).sum())}",
          flush=True)
    if not (rel_l <= 1e-3 and rel_b <= 1e-3 and torch.isfinite(cp["c_concat"]).all()):
        _fail("train-run: the padded batch disagrees with its unpadded twin")
    del model
    torch.cuda.empty_cache()
    return dict(device=device_line, runs=runs, launches=launches, csv_rows=len(rows) - 1,
                padded_vs_unpadded=dict(loss_rel=rel_l, latent_branch_rel_l2=rel_b, c_concat_rel_l2=rel_c,
                                        vae_batch_rel_l2=vae_rel), vae_batch_layers=vae_layers)


CAMERA_CFG_RECIPE = dict(BENCH_RECIPE, camera_cfg=1.5, camera_cfg_scheduler="cosine")  # the 02 CLI's recipe
GEN02_PATH = ("groupnorm", "flash_attention", "temporal_attention", "geglu_ff", "epipolar_flash")


def _guided_request(model, batch, recipe=CAMERA_CFG_RECIPE, **prepare):
    """(z, cond, the guided closure) of one request as `sample` builds them."""
    z, cond = model.prepare_batch(batch, prefetch_uncond=True, **prepare)
    uc = model.build_uncond(cond, z.shape[0], batch["video"].shape[2:4])
    cond.pop("_uncond")
    fn = model.build_guided_fn(cond, uc, model.get_fs(batch), guidance_scale=recipe["guidance_scale"],
                               guidance_rescale=recipe["guidance_rescale"], camera_cfg=recipe["camera_cfg"],
                               camera_cfg_scheduler=recipe["camera_cfg_scheduler"])
    return z, cond, fn


def _guided_limit(kern, twin, got, ref, recipe, step: int):
    """(limit, residual) for one guided evaluation at batch 1, kernels
    (`got`, from its UNet calls `kern` = (e_c, e_u, e_nc)) against the plain
    twins (`ref`, from `twin`): the most the output can move, relative L2,
    given how far each call moved, and how far each side's output is from
    the CFG formula recomputed here in float64 from its own calls.

    comb = e_u + g (e_c - e_u) + c (e_c - e_nc) moves by at most
    A = |1 - g| |de_u| + |g + c| |de_c| + |c| |de_nc|. The rescale gives
    out = k comb, k = phi std(e_c) / std(comb) + 1 - phi, and a std moves
    by at most the RMS of its input's change (a = |de_c| / sqrt(n),
    b = A / sqrt(n)), so |dout| <= k A + phi ((s_c + a) / (s_m - b) -
    s_c / s_m) (|comb| + A). The residuals are added: a fault in the
    closure's combination on the card shows there."""
    g, phi = recipe["guidance_scale"], recipe["guidance_rescale"]
    w = np.float32(1.0) if recipe["camera_cfg_scheduler"] == "constant" else np.cos(
        (np.float32(1.0) - np.float32(step) / np.float32(999.0)) * np.float32(np.pi / 2))
    c = float(np.float32(recipe["camera_cfg"] - 1.0) * w)
    (kc, ku, knc), (tc, tu, tnc) = ([p.double() for p in ps] for ps in (kern, twin))

    def combine(ec, eu, enc):
        m = eu + g * (ec - eu) + c * (ec - enc)
        return m * (phi * ec.std(correction=0) / m.std(correction=0) + 1 - phi), m

    (out_k, _), (out_t, comb) = combine(kc, ku, knc), combine(tc, tu, tnc)
    rn = ref.double().norm()
    residual = (((got.double() - out_k).norm() + (ref.double() - out_t).norm()) / rn).item()
    A = abs(1 - g) * (ku - tu).norm() + abs(g + c) * (kc - tc).norm() + abs(c) * (knc - tnc).norm()
    root_n = comb.numel() ** 0.5
    s_c, s_m, a, b = tc.std(correction=0), comb.std(correction=0), (kc - tc).norm() / root_n, A / root_n
    if b >= s_m:
        return float("inf"), residual
    k = phi * s_c / s_m + 1 - phi
    dk = phi * ((s_c + a) / (s_m - b) - s_c / s_m)
    return ((k * A + dk * (comb.norm() + A)) / rn).item() + residual, residual


def generation_02_phase(dev, device_line: str) -> dict:
    """Phase 10: CamContextI2V-256 generation as the 02 CLI runs it (see the
    module docstring), on the default path."""
    from camc2v_tpu_torch import ops, presets
    from camc2v_tpu_torch.core.schedules import DDIMSchedule
    from camc2v_tpu_torch.models import sampler as sm

    model = presets.build("camcontexti2v_256", seed=4321)
    make = lambda b, seed: camcontext_batch(model, b, seed, dev)  # noqa: E731
    plan = ((1, 81, CAMERA_CFG_RECIPE), (1, 82, CAMERA_CFG_RECIPE), (2, 92, CAMERA_CFG_RECIPE))
    ops.reset_launch_counts()
    requests = generate(model, make, "camcontexti2v camera-cfg", device_line, plan=plan)
    launches = dict(ops.LAUNCHES)
    steps = CAMERA_CFG_RECIPE["ddim_steps"]
    for r in requests:
        r["unet_calls_per_step"] = len(r["unet_calls_ms"]) / steps
    print(f"[10 launches] camera-CFG requests {launches}; UNet calls per step "
          f"{[r['unet_calls_per_step'] for r in requests]}", flush=True)
    if not all(launches[n] > 0 for n in GEN02_PATH):
        _fail(f"generation 02: a kernel of the path never launched: {launches}")
    if any(r["unet_calls_per_step"] != 3 for r in requests):
        _fail("generation 02: camera CFG did not run three UNet calls a step")

    out = dict(requests=requests, launches=launches)
    with torch.no_grad():
        # (b) one guided evaluation and the camera-free pass alone, kernels vs plain twins
        batch = make(1, 83)
        z, cond, fn = _guided_request(model, batch)
        x = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
        t = torch.full((1,), 500, dtype=torch.int32, device=dev)
        parts = {"kernels": [], "twins": []}
        real = model.apply_model

        def recorded(key):
            def call(*a, **k):
                parts[key].append(real(*a, **k))
                return parts[key][-1]
            return call

        model.apply_model = recorded("kernels")
        try:
            got = fn(x, t, 500)
            with ops.plain_twins():
                model.apply_model = recorded("twins")
                ref = fn(x, t, 500)
        finally:
            del model.apply_model
        # CFG 7.5 scales the calls' own differences up against the guided output
        # (7.5 e_c - 6.5 e_u + ...): each UNet call is held to phase 4's tolerance,
        # the output to those calls' differences carried through the combination
        for name, a, b in zip(("conditional", "unconditional", "camera-free"), parts["kernels"], parts["twins"]):
            _rel_check(f"guided evaluation at t=500, its {name} UNet call", a, b)
        if len(parts["kernels"]) != 3 or not torch.isfinite(got).all():
            _fail("generation 02: the guided evaluation did not run its three UNet calls or is not finite")
        guided_rel = ((got - ref).norm() / ref.norm()).item()
        limit, residual = _guided_limit(parts["kernels"], parts["twins"], got, ref, CAMERA_CFG_RECIPE, 500)
        print(f"  guided evaluation with camera CFG 1.5 (cosine) at t=500, 3 UNet calls: kernels vs plain twins "
              f"rel_l2={guided_rel:.3e}, limit from the calls' differences {limit:.3e} (of which the CFG formula's "
              f"residual on the two sides {residual:.3e}, tol 1e-4)", flush=True)
        if not (guided_rel <= limit and residual <= 1e-4):
            _fail("generation 02: the guided evaluation moved more than its UNet calls account for")
        out["guided_rel_l2"], out["guided_limit"], out["guided_residual"] = guided_rel, limit, residual
        del parts
        cond_nc = {k: v for k, v in cond.items() if k != "camera"}
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        got = model.apply_model(x, t, cond_nc, model.get_fs(batch))
        torch.cuda.synchronize()
        moved = {k: ops.LAUNCHES[k] - before[k] for k in before}
        with ops.plain_twins():
            ref = model.apply_model(x, t, cond_nc, model.get_fs(batch))
        _rel_check("the camera-free pass alone", got, ref)
        print(f"  camera-free pass launches {moved}", flush=True)
        if moved["epipolar_flash"] != 0 or moved["temporal_attention"] <= 0:
            _fail(f"generation 02: the camera-free pass launched K6 {moved['epipolar_flash']} times, "
                  f"K3 {moved['temporal_attention']}")
        out["camera_free_launches"] = moved
        del got, ref, cond, cond_nc, fn

        # (c) the latent surgery: paste frame 5 and overlap frames 0-1 from the clean latents
        g = torch.Generator(device=dev).manual_seed(84)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat, cond = model.sample(make(1, 84), generator=g, paste_cond_frame=True, num_overlap=2,
                                 cond_frame_index=5, decode=False, return_cond=True, **CAMERA_CFG_RECIPE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        z0 = cond["origin_z0"]
        exact = bool(torch.equal(lat[:, 5], z0[:, 5]) and torch.equal(lat[:, :2], z0[:, :2]))
        finite = bool(torch.isfinite(lat).all())
        print(f"  latent surgery (paste frame 5, overlap 2, batch 1): {sec:.3f} s, pasted and overlap frames equal "
              f"origin_z0 bit for bit: {exact}, finite: {finite}, other frames' rel distance from origin_z0 "
              f"{((lat[:, 2:5] - z0[:, 2:5]).norm() / z0[:, 2:5].norm()).item():.3f}", flush=True)
        if not (exact and finite):
            _fail("generation 02: the latent surgery did not keep the pasted and overlap frames")
        out["surgery"] = dict(seconds=sec, exact=exact)
        del lat, cond

        # (d) the ancestral loop: the last 25 DDPM steps through the guided closure
        batch = make(1, 85)
        z, cond, fn = _guided_request(model, batch)
        x_T = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(85), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = sm.p_sample_loop(model.schedule, x_T, fn, t_start=25, generator=torch.Generator(device=dev).manual_seed(86))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        finite = bool(torch.isfinite(lat).all())
        print(f"  ancestral p_sample_loop, t_start=25, batch 1: {sec:.3f} s ({sec / 25 * 1e3:.1f} ms a step), "
              f"finite: {finite}, std {lat.std().item():.4f}", flush=True)
        if not finite:
            _fail("generation 02: the ancestral loop's output is not finite")
        out["ancestral"] = dict(seconds=sec, steps=25)
        del lat, cond, fn

        # (e) img2img: the clean latents noised to DDIM step 12 of 25, then decoded from there
        batch = make(1, 87)
        z, cond, fn = _guided_request(model, batch, need_full_z=True)
        ddim = DDIMSchedule.create(model.schedule, 25, CAMERA_CFG_RECIPE["timestep_spacing"],
                                   CAMERA_CFG_RECIPE["ddim_eta"])
        noise = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(87), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = sm.ddim_stochastic_encode(ddim, cond["origin_z0"], 12, noise)
        lat = sm.ddim_decode(ddim, x, fn, 12, generator=torch.Generator(device=dev).manual_seed(88))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        finite = bool(torch.isfinite(lat).all())
        print(f"  img2img: encoded to DDIM step 12 of 25 and decoded, batch 1: {sec:.3f} s, finite: {finite}, "
              f"rel distance from the clean latents {((lat - z).norm() / z.norm()).item():.3f}", flush=True)
        if not finite:
            _fail("generation 02: the img2img output is not finite")
        out["img2img"] = dict(seconds=sec, steps=12)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    padded = padded_context_checks(dev)
    for name, err in padded.items():
        checks[name]["padded_context_max_abs_err"] = err
        checks[name]["max_abs_err"] = max(checks[name]["max_abs_err"], err)
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

    print("[9 train-run] the training entry point on the flagship yaml: synthetic RealEstate10K, 1-4 context "
          "frames padded to 4, validation and checkpoints every 4 micro-steps, resumed", flush=True)
    with _switches("0"):
        train_run = train_run_phase(dev, device_line)

    print("[10 generate-02] CamContextI2V-256 generation as 02_generate_videos.py runs it: camera CFG 1.5 "
          "(cosine), the latent surgery, the ancestral loop, img2img", flush=True)
    with _switches("0"):
        gen02 = generation_02_phase(dev, device_line)

    first = train_run["vae_batch_layers"]["first_differing"]
    if first is not None and first["kind"].startswith("GroupNorm"):
        _fail(f"the VAE's batch dependence starts at a GroupNorm ({first})")

    with open(os.path.join(OUT_DIR, "chip_smoke_summary.json"), "w") as f:
        json.dump(dict(device=device_line, requests=requests, unet_step=step, launches_dynamicrafter=dc_launches,
                       launches_camcontexti2v=cc_launches, train=train, routes=routes, train_run=train_run,
                       generation_02=gen02, kernels=checks), f, indent=1, default=str)
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
        "groupnorm_big": ("camc2v_tpu_torch/csrc/groupnorm.cu", "camc2v_tpu/ops/groupnorm.py:160"),  # K1's plan
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
             launches_train_run=train_run["launches"][name], launches_generation_02=gen02["launches"][name],
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
