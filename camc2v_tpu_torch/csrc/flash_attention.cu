// K2: online-softmax (flash) attention forward over (B, L, H, D) bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/flash_attention.py::
// _fwd_kernel_nomask / _fwd_kernel / _fwd_kernel_sparse (entry
// flash_attention). Same arithmetic: q is pre-scaled in bf16, QK^T and PV are
// bf16 products accumulated in f32, the running max is floored at -1e20 so
// masked logits (-1e30) give exactly 0, an optional (B, Lq, Lk) bool mask is
// shared across heads, key tiles whose mask tile is empty are skipped (the
// TPU kernel's scalar-prefetched bitmap), keys past Lk are masked (the TPU
// path padded them to a BLOCK_K multiple), and fully masked rows give 0.
// For the training backward (K5) it also writes each row's logsumexp, as the
// TPU kernel's `with_stats` variant does.
//
// On the H100 the op is tensor-core bound at the UNet's long spatial
// self-attention (L=1024) and latency bound at the short cross-attention
// keys (77 text / 16 image tokens). The body is the simple form shared with
// K6 (flash_core.cuh); the bool-mask policy lives there too.
// wgmma/TMA pipelining is later work.
#include "flash_core.cuh"

namespace {

__global__ void __launch_bounds__(flash::WARPS * 32)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const uint8_t* __restrict__ mask, const uint8_t* __restrict__ tile_any,
                 bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int H, int D, float scale,
                 long long mask_bstride, int nq, int nk) {
  extern __shared__ __align__(128) unsigned char smem[];
  flash::BoolMask m{mask, tile_any, mask_bstride, Lq, Lk, nq, nk};
  flash::attention_body(q, k, v, out, lse, Lq, Lk, Lk, H, D, scale, nk, smem, m);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, H, D), out (B, Lq, H, D): contiguous bf16.
// mask: optional (B or 1, Lq, Lk) bool with batch stride mask_bstride;
// tile_any: optional (B, ceil(Lq/64), ceil(Lk/64)) uint8 non-empty-tile map.
// lse: (B, H, Lq) f32 or null (the generation path).
// `scale` is the bf16-rounded softmax scale. D must be a multiple of 16, <= 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* tile_any, void* out, void* lse, int B, int Lq, int Lk, int H, int D,
                         float scale, long long mask_bstride, void* stream) {
  if (D % 16 != 0 || D > 128) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ, nk = (Lk + flash::BK - 1) / flash::BK;
  const size_t smem = flash::core_smem_bytes(D);
  cudaFuncSetAttribute(flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RETURN_IF_ERR();
  dim3 grid(nq, H, B);
  flash_fwd_kernel<<<grid, flash::WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint8_t*)mask, (const uint8_t*)tile_any,
      (bf16*)out, (float*)lse, Lq, Lk, H, D, scale, mask_bstride, nq, nk);
  RETURN_IF_ERR();
  return 0;
}
