// What K1 (groupnorm.cu) and K9 (groupnorm_twophase.cu) share: a row's
// 16-byte pieces (8 bf16 or 4 f32 channels) as f32, the normalisation of a
// piece with its channels' constants in registers, and the apply pass over
// one sample's slice of rows that both two-launch paths end with.
#pragma once

#include "common.cuh"

namespace {

constexpr int K9_UNROLL = 4;  // 16-byte loads in flight per thread (ops/groupnorm.py::K9_UNROLL)

// one 16-byte piece of a row: VEC channels, as f32
template <typename T> struct Piece;
template <> struct Piece<bf16> {
  static constexpr int VEC = 8;
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
template <> struct Piece<float> {
  static constexpr int VEC = 4;
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

// y = (x - mean) * inv * scale + bias [, SiLU], per channel of a piece.
// The SiLU a / (1 + exp(-a)) takes the exponential and the division from
// the special-function unit (ex2.approx, rcp.approx: relative errors near
// 2^-22, far below a bf16 ulp); the accurate expf and IEEE reciprocal made
// the apply pass compute-bound.
template <int VEC, bool SILU>
__device__ __forceinline__ void normalise(float (&v)[VEC], const float (&mean)[VEC], const float (&inv)[VEC],
                                          const float (&sc)[VEC], const float (&bi)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float a = (v[j] - mean[j]) * inv[j];
    a = a * sc[j] + bi[j];
    v[j] = SILU ? __fdividef(a, 1.f + __expf(-a)) : a;
  }
}

// The apply pass of a grid (splits, B) of (C / VEC) * rgroups threads over
// x (B, rows, c) with per-channel stats (B, 2, c) (mean, then inverse std):
// thread (rg, p) normalises piece p of rows r0 + rg, r0 + rg + rgroups, ...
// of its block's slice [r0, r1), its channels' constants in registers,
// K9_UNROLL 16-byte loads in flight.
template <typename T, bool SILU>
__device__ __forceinline__ void apply_slice(const T* __restrict__ x, const float* __restrict__ stats,
                                            const float* __restrict__ scale, const float* __restrict__ bias,
                                            T* __restrict__ y, long long rows, int c, int splits, int rgroups) {
  constexpr int VEC = Piece<T>::VEC;
  const int pieces = c / VEC;
  const int tid = threadIdx.x, rg = tid / pieces, c0 = (tid % pieces) * VEC;
  const int si = blockIdx.x, b = blockIdx.y;
  const long long r0 = rows * si / splits, r1 = rows * (si + 1) / splits;
  const float* st = stats + (long long)b * 2 * c;
  float mean[VEC], inv[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = st[c0 + j];
    inv[j] = st[c + c0 + j];
    sc[j] = scale[c0 + j];
    bi[j] = bias[c0 + j];
  }
  const long long base = (long long)b * rows * c + c0;
  long long r = r0 + rg;
  for (; r + (K9_UNROLL - 1) * rgroups < r1; r += K9_UNROLL * rgroups) {
    float v[K9_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < K9_UNROLL; ++u) Piece<T>::load(x + base + (r + u * rgroups) * c, v[u]);
#pragma unroll
    for (int u = 0; u < K9_UNROLL; ++u) {
      normalise<VEC, SILU>(v[u], mean, inv, sc, bi);
      Piece<T>::store(y + base + (r + u * rgroups) * c, v[u]);
    }
  }
  for (; r < r1; r += rgroups) {
    float v[VEC];
    Piece<T>::load(x + base + r * c, v);
    normalise<VEC, SILU>(v, mean, inv, sc, bi);
    Piece<T>::store(y + base + r * c, v);
  }
}

}  // namespace
