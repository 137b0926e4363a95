// K7: epipolar flash attention backward (dq; dk and dv) with the mask
// recomputed from the epipolar lines inside the kernels, over (B, L, H, D)
// bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/epipolar_flash.py::
// _v2_bwd_dq_kernel and _v2_bwd_dkv_kernel (entry _epipolar_flash_bwd_impl,
// the custom VJP of epipolar_flash_attention). Given q, k, v, the lines, the
// hull map, K6's output and logsumexp, and dout, it computes
// dq = scale * sum_k ds k, dk = sum_q ds qs and dv = sum_q p dout with
// qs = bf16(q * scale), delta = rowsum(dout * out) (f32), p = exp(qs k - lse),
// ds = p (dout v - delta), under the same mask bits as K6 (the `LineMask`
// policy of epipolar_mask.cuh: one distance formula, one rounding order) and
// the same tile skips, which are exact here too: a skipped tile has p = 0,
// so ds = 0.
//
// The kernels are the Hopper core's backward (flash_hopper_kernels.cuh),
// K5's: the pre-pass forms qs and delta on the card as the JAX backward
// forms them (and pads nothing: Lq is a whole number of 128-query tiles),
// then the dq sweep (one block per 64-query tile, looping over key tiles)
// and the dk/dv sweep (one block per 64-key tile, looping over the query
// tiles the map leaves on), so each output is
// written once with its f32 sum finished in registers and no atomics. At the
// ds8 site the dk/dv sweep sums over 16384 queries and the adaptor's 3072
// keys see 16384 queries: every sum stays in f32 until the single bf16
// store. Like K6, the op's least time is set by bytes (sparse masks); the
// work after skipping is the pairs of the tiles the map leaves on.
#include "epipolar_mask.cuh"
#include "flash_hopper_kernels.cuh"

using namespace hflash;

// q, out, dout (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H, D): contiguous
// bf16, 16-byte aligned; lse (B, H, Lq) f32 from K6; lines_t, tile_any, the
// geometry and `scale` as for epipolar_flash_fwd. Scratch from the caller:
// qs (B, Lq, H, D) bf16, lse_pad and delta_pad (B, H, Lq) f32. Writes dq
// (B, Lq, H, D), dk and dv (B, Lk, H, D) bf16.
extern "C" int epipolar_flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                                  const void* lse, const void* lines_t, const void* tile_any, void* qs,
                                  void* lse_pad, void* delta_pad, void* dq, void* dk, void* dv, int B, int Lq,
                                  int Lk, int H, int D, int t, int hw, int w, int nreg, int cols, float scale,
                                  float ds, float thresh, void* stream) {
  if (!epipolar_args_ok(D, Lq, Lk, t, hw, nreg, cols)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_prepass(q, out, dout, lse, qs, lse_pad, delta_pad, B, Lq, Lq, H, D, scale, s);
  if (err != 0) return err;
  const CUtensorMap none = {};
  const BwdParams<LineMask> p{make_line_mask(lines_t, tile_any, Lq, t, hw, w, nreg, cols, ds, thresh),
                              (const float*)lse_pad, (const float*)delta_pad, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                              Lq, Lq, Lk, H, D, scale};
  return padded_d(D) == 64 ? launch_sweeps<64>(qs, k, v, dout, none, none, B, p, s)
                           : launch_sweeps<128>(qs, k, v, dout, none, none, B, p, s);
}
