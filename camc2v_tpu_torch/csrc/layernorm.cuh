// Row LayerNorm with f32 statistics over (rows, C), output in x's dtype: the
// kernel of K8 (layernorm.cu) and the LayerNorm pass of K3 and K4
// (temporal_attention.cu, geglu_ff.cu), which write bf16 LN(x) to scratch
// before their GEMMs.
//
// Per row: mean = sum(x) / C, var = sum((x - mean)^2) / C (the exact
// two-pass variance), y = (x - mean) * rsqrt(var + eps) * scale + bias, all
// in f32, then rounded to x's dtype. Bound by HBM bytes (x read once, y
// written once). A row is read once into registers: `lanes` lanes of a warp
// (a power of two, the fewest that leave each lane at most TARGET_PER_LANE
// 16-byte pieces) own it, lane l its pieces l, l + lanes, ... (neighbouring
// lanes on neighbouring 16 bytes), so at C = 320 bf16 eight lanes hold five
// pieces each and a warp normalises four rows. Both passes and the apply
// run from the registers, the sums meet by shuffles within the row's lanes,
// and each piece is written back as one 16-byte store.
#pragma once

#include "common.cuh"

namespace ln {

constexpr int THREADS = 256;
constexpr int TARGET_PER_LANE = 8;  // ops/layernorm.py::LN_TARGET_PER_LANE
constexpr int MAX_PER_LANE = 16;    // ops/layernorm.py::LN_MAX_PER_LANE

template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const bf16* p, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 v = __bfloat1622float2(e[j]);
      f[2 * j] = v.x;
      f[2 * j + 1] = v.y;
    }
  }
  __device__ __forceinline__ static void store(bf16* p, const float (&f)[8]) {
    uint4 u;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) e[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

// the sum of v over the `lanes` lanes of this thread's row (every lane of
// the warp takes part)
__device__ __forceinline__ float row_sum(float v, int lanes) {
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lanes per row for a row of `pieces` 16-byte pieces
__host__ __device__ inline int lanes_for(int pieces) {
  int lanes = 1;
  while (lanes < 32 && (pieces + lanes - 1) / lanes > TARGET_PER_LANE) lanes *= 2;
  return lanes;
}

// P = the pieces of a lane (ceil(pieces / lanes)); rows of THREADS / lanes a block
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ln_rows(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias, T* __restrict__ y,
        long long rows, int c, int lanes, float eps) {
  constexpr int VEC = Vec<T>::N;
  const int pieces = c / VEC;
  const int sub = threadIdx.x % lanes;
  const long long row = (long long)blockIdx.x * (THREADS / lanes) + threadIdx.x / lanes;
  const bool live = row < rows;
  const T* xr = x + row * c;
  float v[P][VEC];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = j * lanes + sub;
    if (live && p < pieces) {
      Vec<T>::load(xr + p * VEC, v[j]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) s += v[j][e];
  }
  const float mean = row_sum(s, lanes) / (float)c;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j * lanes + sub < pieces) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[j][e] - mean;
        q += d * d;
      }
    }
  }
  const float inv = rsqrtf(row_sum(q, lanes) / (float)c + eps);
  if (!live) return;
  T* yr = y + row * c;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = j * lanes + sub;
    if (p < pieces) {
      const int c0 = p * VEC;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {
        const float4 sc = *reinterpret_cast<const float4*>(scale + c0 + e);
        const float4 bi = *reinterpret_cast<const float4*>(bias + c0 + e);
        v[j][e] = (v[j][e] - mean) * inv * sc.x + bi.x;
        v[j][e + 1] = (v[j][e + 1] - mean) * inv * sc.y + bi.y;
        v[j][e + 2] = (v[j][e + 2] - mean) * inv * sc.z + bi.z;
        v[j][e + 3] = (v[j][e + 3] - mean) * inv * sc.w + bi.w;
      }
      Vec<T>::store(yr + c0, v[j]);
    }
  }
}

// y = LN(x) over (rows, c) on `stream`; x, y, scale and bias on 16-byte
// boundaries, c a multiple of a 16-byte piece's channels (8 bf16, 4 f32)
// with at most 32 * MAX_PER_LANE pieces
template <typename T>
inline int launch(const T* x, const float* scale, const float* bias, T* y, long long rows, int c, float eps,
                  cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const int pieces = c / VEC;
  if (c % VEC != 0 || pieces < 1 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int lanes = lanes_for(pieces);
  const int per = (pieces + lanes - 1) / lanes;
  const int rows_per_block = THREADS / lanes;
  const unsigned blocks = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  switch (per) {
#define LN_CASE(P)                                                                               \
  case P:                                                                                        \
    ln_rows<T, P><<<blocks, THREADS, 0, stream>>>(x, scale, bias, y, rows, c, lanes, eps); \
    break;
    LN_CASE(1) LN_CASE(2) LN_CASE(3) LN_CASE(4) LN_CASE(5) LN_CASE(6) LN_CASE(7) LN_CASE(8)
    LN_CASE(9) LN_CASE(10) LN_CASE(11) LN_CASE(12) LN_CASE(13) LN_CASE(14) LN_CASE(15) LN_CASE(16)
#undef LN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  RETURN_IF_ERR();
  return 0;
}

}  // namespace ln
