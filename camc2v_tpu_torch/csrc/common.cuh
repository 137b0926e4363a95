// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel file exposes a plain C entry point that launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define RETURN_IF_ERR()                          \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

// 16-byte global -> shared copy that bypasses the registers (sm_80+ cp.async);
// both addresses 16-byte aligned. Completion is tracked per commit group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of the committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// f32 LayerNorm of one row of `c` bf16 values by one warp, two-pass variance
// (the JAX kernels' `mean(square(x - mean))`), written as bf16 to `dst`.
// Scale/bias are f32. Matches `(x - mean) * rsqrt(var + eps) * s + b`.
__device__ __forceinline__ void warp_layernorm_row(const bf16* src, bf16* dst, int c,
                                                   const float* s, const float* b, float eps,
                                                   int lane) {
  float sum = 0.f;
  for (int i = lane; i < c; i += 32) sum += __bfloat162float(src[i]);
  float mean = warp_sum(sum) / (float)c;
  float sq = 0.f;
  for (int i = lane; i < c; i += 32) {
    float d = __bfloat162float(src[i]) - mean;
    sq += d * d;
  }
  float inv = rsqrtf(warp_sum(sq) / (float)c + eps);
  for (int i = lane; i < c; i += 32) {
    float v = (__bfloat162float(src[i]) - mean) * inv;
    dst[i] = __float2bfloat16(v * s[i] + b[i]);
  }
}
