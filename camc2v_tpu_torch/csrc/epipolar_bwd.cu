// K7: epipolar flash attention backward (dq; dk and dv) with the mask
// recomputed from the epipolar lines inside the kernels, over (B, L, H, D)
// bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/epipolar_flash.py::
// _v2_bwd_dq_kernel and _v2_bwd_dkv_kernel (entry _epipolar_flash_bwd_impl,
// the custom VJP of epipolar_flash_attention). Given k, v, the lines, the
// hull map, dout, K6's logsumexp, and qs = bf16(q * scale) and
// delta = rowsum(dout * out) (f32), both formed by the wrapper as the JAX
// backward forms them, it computes dq = scale * sum_k ds k, dk = sum_q ds qs
// and dv = sum_q p dout with p = exp(qs k - lse), ds = p (dout v - delta), under
// the same mask bits as K6 (the policy of epipolar_mask.cuh: one distance
// formula, one rounding order) and the same subtile skips, which are exact
// here too: a skipped subtile has p = 0, so ds = 0.
//
// Two kernels, as the JAX grid has: the dq sweep (one block per 64-query
// tile, looping over key tiles) and the dk/dv sweep (one block per 64-key
// tile, looping over query tiles), so each output is written once with its
// f32 sum finished in shared memory and no atomics. At the ds8 site the
// dk/dv sweep sums over 16384 queries and the adaptor's 3072 keys see 16384
// queries: every sum stays in f32 until the single bf16 store. Like K6, the
// op's least time is set by bytes (sparse masks); the simple WMMA core here
// recomputes the scores in both sweeps and runs far from the card's peak.
#include "epipolar_mask.cuh"

namespace {

__global__ void __launch_bounds__(flash::WARPS * 32)
epipolar_bwd_dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                       const bf16* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, const float* __restrict__ lines,
                       const int* __restrict__ tile_any, bf16* __restrict__ dq, int Lq, int Lk, int H, int D,
                       int t, int hw, int w, int nreg, int block_q, int sub, int cols, float scale, float ds,
                       float thresh) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + flash::bwd_smem_bytes(D, 1));
  LineMask m = make_line_mask(lines, tile_any, Lq, t, hw, w, nreg, block_q, sub, cols, ds, thresh, stage);
  const int lk_valid = t * hw + nreg;
  const int nk = (lk_valid + flash::BK - 1) / flash::BK;
  flash::bwd_dq_body(qs, k, v, dout, lse, delta, dq, Lq, Lk, lk_valid, H, D, scale, nk, smem, m);
}

__global__ void __launch_bounds__(flash::WARPS * 32)
epipolar_bwd_dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const float* __restrict__ lines,
                        const int* __restrict__ tile_any, bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq,
                        int Lk, int H, int D, int t, int hw, int w, int nreg, int block_q, int sub, int cols,
                        float ds, float thresh) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + flash::bwd_smem_bytes(D, 2));
  LineMask m = make_line_mask(lines, tile_any, Lq, t, hw, w, nreg, block_q, sub, cols, ds, thresh, stage);
  const int lk_valid = t * hw + nreg;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ;
  flash::bwd_dkv_body(qs, k, v, dout, lse, delta, dk, dv, Lq, Lk, lk_valid, H, D, nq, smem, m);
}

}  // namespace

// qs = bf16(q * scale) and dout (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H,
// D): contiguous bf16; lse, delta (B, H, Lq) f32; lines, tile_any, the
// geometry and `scale` as for epipolar_flash_fwd. Writes dq (B, Lq, H, D),
// dk and dv (B, Lk, H, D) bf16.
extern "C" int epipolar_flash_bwd(const void* qs, const void* k, const void* v, const void* dout, const void* lse,
                                  const void* delta, const void* lines, const void* tile_any, void* dq, void* dk,
                                  void* dv, int B, int Lq, int Lk, int H, int D, int t, int hw, int w, int nreg,
                                  int block_q, int sub, int cols, float scale, float ds, float thresh,
                                  void* stream) {
  if (!epipolar_args_ok(D, hw, sub, block_q, nreg, Lk, t)) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ, nk = (Lk + flash::BK - 1) / flash::BK;
  const size_t smem_dq = flash::bwd_smem_bytes(D, 1) + STAGE_FLOATS * sizeof(float);
  const size_t smem_dkv = flash::bwd_smem_bytes(D, 2) + STAGE_FLOATS * sizeof(float);
  cudaFuncSetAttribute(epipolar_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  cudaFuncSetAttribute(epipolar_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  RETURN_IF_ERR();
  cudaStream_t s = (cudaStream_t)stream;
  epipolar_bwd_dq_kernel<<<dim3(nq, H, B), flash::WARPS * 32, smem_dq, s>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (const float*)lines, (const int*)tile_any, (bf16*)dq, Lq, Lk, H, D, t, hw, w, nreg, block_q, sub, cols,
      scale, ds, thresh);
  RETURN_IF_ERR();
  epipolar_bwd_dkv_kernel<<<dim3(nk, H, B), flash::WARPS * 32, smem_dkv, s>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (const float*)lines, (const int*)tile_any, (bf16*)dk, (bf16*)dv, Lq, Lk, H, D, t, hw, w, nreg, block_q,
      sub, cols, ds, thresh);
  RETURN_IF_ERR();
  return 0;
}
