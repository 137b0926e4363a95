// Row LayerNorm with f32 statistics over (rows, C), output in x's dtype: the
// kernel of K8 (layernorm.cu) and the LayerNorm pass of K3 and K4
// (temporal_attention.cu, geglu_ff.cu), which write bf16 LN(x) to scratch
// before their GEMMs.
//
// Per row: mean = sum(x) / C, var = sum((x - mean)^2) / C (the exact
// two-pass variance), y = (x - mean) * rsqrt(var + eps) * scale + bias, all
// in f32, then rounded to x's dtype. Bound by HBM bytes: one warp owns one
// row and reads it coalesced as channel pairs (bf16x2 / float2); the three
// passes over the row (sum, squared deviation, apply) re-read it from L1, so
// device memory sees it once.
#pragma once

#include "common.cuh"

namespace ln {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<bf16>(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ln_rows(const T* __restrict__ x, const float* __restrict__ scale,
                                                   const float* __restrict__ bias, T* __restrict__ y,
                                                   long long rows, int c, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + row * c;
  T* yr = y + row * c;
  const int pairs = c / 2;
  float s = 0.f;
  for (int p = lane; p < pairs; p += 32) {
    const float2 v = load2<T>(xr + 2 * p);
    s += v.x + v.y;
  }
  const float mean = warp_sum(s) / (float)c;
  float q = 0.f;
  for (int p = lane; p < pairs; p += 32) {
    const float2 v = load2<T>(xr + 2 * p);
    const float d0 = v.x - mean, d1 = v.y - mean;
    q += d0 * d0 + d1 * d1;
  }
  const float inv = rsqrtf(warp_sum(q) / (float)c + eps);
  for (int p = lane; p < pairs; p += 32) {
    const float2 v = load2<T>(xr + 2 * p);
    const int c0 = 2 * p;
    store2<T>(yr + c0, (v.x - mean) * inv * scale[c0] + bias[c0], (v.y - mean) * inv * scale[c0 + 1] + bias[c0 + 1]);
  }
}

// y = LN(x) over (rows, c) on `stream`: one warp per row, ROWS_PER_BLOCK rows
// per block; c even
template <typename T>
inline int launch(const T* x, const float* scale, const float* bias, T* y, long long rows, int c, float eps,
                  cudaStream_t stream) {
  if (c % 2 != 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  ln_rows<T><<<(unsigned)blocks, THREADS, 0, stream>>>(x, scale, bias, y, rows, c, eps);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace ln
