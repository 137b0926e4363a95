// K5: flash attention backward (dq; dk and dv) over (B, L, H, D) bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and _bwd_dkv_kernel (entry _flash_bwd_impl, the custom VJP
// of flash_attention). Given k, v, the optional head-shared bool mask and
// its 64x64 tile map, dout, K2's logsumexp, and qs = bf16(q * scale) and
// delta = rowsum(dout * out) (f32), both formed by the wrapper as the JAX
// backward forms them, it computes dq = scale * sum_k ds k, dk = sum_q ds qs,
// dv = sum_q p dout with p = exp(qs k - lse), ds = p (dout v - delta):
// ds and p rounded to bf16 for the products, every
// sum in f32, empty mask tiles skipped (exact: p = 0 there), keys past Lk
// masked, and a fully masked row (lse = +1e30) contributes nothing.
//
// Two kernels, as the JAX grid has: the dq sweep (one block per 64-query
// tile, looping over key tiles) and the dk/dv sweep (one block per 64-key
// tile, looping over query tiles), so each output is finished in shared
// memory and stored once, with no atomics. Both recompute the scores from qs
// and k. On the H100 the op is tensor-core bound at the UNet's spatial
// self-attention (Lq = Lk = 1024) and latency bound at the short
// cross-attention keys; this simple WMMA form runs far from the peak.
#include "flash_core.cuh"

namespace {

__global__ void __launch_bounds__(flash::WARPS * 32)
flash_bwd_dq_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ tile_any, bf16* __restrict__ dq,
                    int Lq, int Lk, int H, int D, float scale, long long mask_bstride, int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash::BoolMask m{mask, tile_any, mask_bstride, Lq, Lk, nq, nk};
  flash::bwd_dq_body(qs, k, v, dout, lse, delta, dq, Lq, Lk, Lk, H, D, scale, nk, smem, m);
}

__global__ void __launch_bounds__(flash::WARPS * 32)
flash_bwd_dkv_kernel(const bf16* __restrict__ qs, const bf16* __restrict__ k, const bf16* __restrict__ v,
                     const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                     const uint8_t* __restrict__ mask, const uint8_t* __restrict__ tile_any, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int Lq, int Lk, int H, int D, long long mask_bstride, int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash::BoolMask m{mask, tile_any, mask_bstride, Lq, Lk, nq, nk};
  flash::bwd_dkv_body(qs, k, v, dout, lse, delta, dk, dv, Lq, Lk, Lk, H, D, nq, smem, m);
}

}  // namespace

// qs = bf16(q * scale) and dout (B, Lq, H, D), k/v (B, Lk, H, D): contiguous
// bf16; lse, delta (B, H, Lq) f32; mask and tile_any as for flash_fwd;
// `scale` the bf16-rounded softmax scale. Writes dq (B, Lq, H, D), dk and dv
// (B, Lk, H, D) bf16.
extern "C" int flash_bwd(const void* qs, const void* k, const void* v, const void* dout, const void* lse,
                         const void* delta, const void* mask, const void* tile_any, void* dq, void* dk, void* dv,
                         int B, int Lq, int Lk, int H, int D, float scale, long long mask_bstride, void* stream) {
  if (D % 16 != 0 || D > 128) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ, nk = (Lk + flash::BK - 1) / flash::BK;
  const size_t smem_dq = flash::bwd_smem_bytes(D, 1), smem_dkv = flash::bwd_smem_bytes(D, 2);
  cudaFuncSetAttribute(flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  cudaFuncSetAttribute(flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  RETURN_IF_ERR();
  cudaStream_t s = (cudaStream_t)stream;
  flash_bwd_dq_kernel<<<dim3(nq, H, B), flash::WARPS * 32, smem_dq, s>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (const uint8_t*)mask, (const uint8_t*)tile_any, (bf16*)dq, Lq, Lk, H, D, scale, mask_bstride, nq, nk);
  RETURN_IF_ERR();
  flash_bwd_dkv_kernel<<<dim3(nk, H, B), flash::WARPS * 32, smem_dkv, s>>>(
      (const bf16*)qs, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse, (const float*)delta,
      (const uint8_t*)mask, (const uint8_t*)tile_any, (bf16*)dk, (bf16*)dv, Lq, Lk, H, D, mask_bstride, nq, nk);
  RETURN_IF_ERR();
  return 0;
}
