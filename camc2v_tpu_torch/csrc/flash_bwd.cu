// K5: flash attention backward (dq; dk and dv) over (B, L, H, D) bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and _bwd_dkv_kernel (entry _flash_bwd_impl, the custom VJP
// of flash_attention). Given q, k, v, the optional head-shared bool mask and
// its tile map, K2's output and logsumexp, and dout, it computes
// dq = scale * sum_k ds k, dk = sum_q ds qs, dv = sum_q p dout with
// qs = bf16(q * scale), p = exp(qs k - lse), ds = p (dout v - delta),
// delta = rowsum(dout * out) in f32: ds and p rounded to bf16 for the
// products, every sum in f32, dq rounded as bf16(bf16(ds K) * scale), empty
// mask tiles skipped (exact: p = 0 there), keys past Lk masked, and a fully
// masked row (lse = +1e30) contributes nothing.
//
// On the H100 the op is tensor-core bound at the UNet's spatial
// self-attention (Lq = Lk = 1024; 14 D operations per pair with the scores
// recomputed in both sweeps) and latency bound at the short cross-attention
// keys. The kernels are the Hopper core's backward (flash_hopper_kernels.cuh:
// the pre-pass, then the dq and the dk/dv sweeps, each a TMA producer warp
// and one wgmma consumer warpgroup, two blocks per SM) under the `BoolMask`
// policy.
#include "flash_hopper_kernels.cuh"

using namespace hflash;

// q, out, dout (B, Lq, H, D), k/v (B, Lk, H, D): contiguous bf16, 16-byte
// aligned; lse (B, H, Lq) f32 from K2; mask and tile_any as for flash_fwd
// (the padded uint8 mask over 128 x 64 tiles); `scale` the bf16-rounded
// softmax scale. Scratch from the caller: qs (B, Lq, H, D) bf16, lse_pad
// and delta_pad (B, H, LqP) f32 with LqP = 128 * ceil(Lq / 128). Writes dq
// (B, Lq, H, D), dk and dv (B, Lk, H, D) bf16.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                         const void* lse, const void* mask, const void* tile_any, void* qs, void* lse_pad,
                         void* delta_pad, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
                         float scale, long long mask_bstride, void* stream) {
  if (D % 16 != 0 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK, LqP = nq * BQ;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_prepass(q, out, dout, lse, qs, lse_pad, delta_pad, B, Lq, LqP, H, D, scale, s);
  if (err != 0) return err;
  // the padded mask's tensor maps, with boxes of the dq sweep's 64 query rows
  // and the dk/dv sweep's streamed query tiles
  const int Bm = mask_bstride == 0 ? 1 : B;
  const int nqs = padded_d(D) == 64 ? DkvSmem<64, BoolMask>::NQS : DkvSmem<128, BoolMask>::NQS;
  CUtensorMap tm = {}, tm2 = {};
  if (mask != nullptr &&
      (!mask_map(&tm, mask, Bm, nq * BQ, nk * BK, ROWS) || !mask_map(&tm2, mask, Bm, nq * BQ, nk * BK, nqs)))
    return (int)cudaErrorInvalidValue;
  const BwdParams<BoolMask> p{BoolMask{(const uint8_t*)tile_any, nq, nk, mask != nullptr, mask_bstride == 0},
                              (const float*)lse_pad, (const float*)delta_pad, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                              Lq, LqP, Lk, H, D, scale};
  return padded_d(D) == 64 ? launch_sweeps<64>(qs, k, v, dout, tm, tm2, B, p, s)
                           : launch_sweeps<128>(qs, k, v, dout, tm, tm2, B, p, s);
}
