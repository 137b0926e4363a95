// K9 and K10: GroupNorm(+SiLU) with statistics per (sample, group) over a
// long sequence of frames, from f32 raw moments with the single-pass
// variance max(E[x^2] - E[x]^2, 0).
//
// K9 replaces the Pallas kernels camc2v_tpu/ops/groupnorm.py::
// _gn_row_moments_kernel + _gn_apply_kernel (entry group_norm_fused_temporal):
// x is viewed as (B*T, HW, C); the first launch writes per-row-block partial
// per-channel sums of x and x*x (gn_row_moments), the caller combines them
// into per-(B, group) mean and inverse std on a (B, 2, C) array (as the JAX
// package does in its graph), and the second launch applies them with scale,
// bias and the optional SiLU (gn_apply_stats).
//
// K10 replaces camc2v_tpu/ops/groupnorm.py::_gn_big_kernel (entry
// group_norm_fused_big): the same function in ONE launch over (B, T*HW, C).
// The TPU kernel walked its (B, 2, T) grid in order and carried the sums in
// VMEM from phase 0 to phase 1; Hopper blocks run in no order, so K10 is a
// cooperative launch (every block resident at once, the grid no larger than
// the card holds) with two grid-wide barriers: phase 0 writes each block's
// partial sums, phase 1 reduces them per (sample, moment), phase 2 combines
// the groups and applies.
//
// Bound by HBM bytes: x is read twice (moments, apply) and y written once.
// Sums are blocked: each thread sums a strided subset of one block's rows
// per channel pair, the threads of a block meet in shared memory, and the
// partials of the blocks are summed afterwards, so no single f32 running sum
// spans a whole sample.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

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

// threads of a block: channel pairs across (up to 256), row groups down
inline int block_threads(int c) {
  const int pairs = c / 2;
  const int tpr = pairs < 256 ? pairs : 256;
  return tpr * (256 / tpr);
}

// per-channel sum and sum of squares of rows [r0, r1) of `xs` (rows x c),
// accumulated into acc[0, c) and acc[c, 2c) in shared memory (zeroed and
// synchronised by the caller)
template <typename T>
__device__ __forceinline__ void row_moments(const T* __restrict__ xs, long long r0, long long r1, int c,
                                            float* acc) {
  const int pairs = c / 2;
  const int tpr = pairs < (int)blockDim.x ? pairs : (int)blockDim.x;
  const int rgroups = blockDim.x / tpr;
  const int rg = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  for (int p = lane; p < pairs; p += tpr) {
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
    for (long long r = r0 + rg; r < r1; r += rgroups) {
      const float2 v = load2<T>(xs + r * c + 2 * p);
      s0 += v.x;
      s1 += v.y;
      q0 += v.x * v.x;
      q1 += v.y * v.y;
    }
    atomicAdd(&acc[2 * p], s0);
    atomicAdd(&acc[2 * p + 1], s1);
    atomicAdd(&acc[c + 2 * p], q0);
    atomicAdd(&acc[c + 2 * p + 1], q1);
  }
}

// y = (x - mean_c) * inv_c * scale + bias [, SiLU] over rows [r0, r1)
template <typename T>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, T* __restrict__ y, long long r0,
                                           long long r1, int c, const float* mean_c, const float* inv_c,
                                           const float* __restrict__ scale, const float* __restrict__ bias,
                                           int silu) {
  const int pairs = c / 2;
  const long long total = (r1 - r0) * pairs;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int c0 = 2 * (int)(i % pairs);
    const long long off = (r0 + i / pairs) * c + c0;
    const float2 v = load2<T>(x + off);
    float a = (v.x - mean_c[c0]) * inv_c[c0];
    float b = (v.y - mean_c[c0 + 1]) * inv_c[c0 + 1];
    a = a * scale[c0] + bias[c0];
    b = b * scale[c0 + 1] + bias[c0 + 1];
    if (silu) {
      a = a * (1.f / (1.f + expf(-a)));
      b = b * (1.f / (1.f + expf(-b)));
    }
    store2<T>(y + off, a, b);
  }
}

// K9 phase 1: ws[n, si, 0:c] = sum, ws[n, si, c:2c] = sum of squares over
// row block si of sample-row n
template <typename T>
__global__ void __launch_bounds__(256) gn_row_moments_kernel(const T* __restrict__ x, float* __restrict__ ws,
                                                             long long rows, int c, int split) {
  extern __shared__ float acc[];  // 2c
  const int ni = blockIdx.y, si = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) acc[i] = 0.f;
  __syncthreads();
  row_moments<T>(x + (long long)ni * rows * c, rows * si / split, rows * (si + 1) / split, c, acc);
  __syncthreads();
  float* out = ws + ((long long)ni * split + si) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) out[i] = acc[i];
}

// K9 phase 2: stats (N / t, 2, c) f32 per-channel mean and inverse std
template <typename T>
__global__ void __launch_bounds__(256) gn_apply_stats_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                                                             const float* __restrict__ scale,
                                                             const float* __restrict__ bias, T* __restrict__ y,
                                                             long long rows, int c, int t, int split, int silu) {
  extern __shared__ float st[];  // mean_c, inv_c
  const int ni = blockIdx.y, si = blockIdx.x;
  const float* s = stats + (long long)(ni / t) * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) st[i] = s[i];
  __syncthreads();
  const long long base = (long long)ni * rows * c;
  apply_rows<T>(x + base, y + base, rows * si / split, rows * (si + 1) / split, c, st, st + c, scale, bias, silu);
}

// K10: one cooperative launch over (B, rows, c); grid (nb, B); ws holds
// (B, nb, 2c) partials then (B, 2c) totals
template <typename T>
__global__ void __launch_bounds__(256) gn_big_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                                     const float* __restrict__ bias, T* __restrict__ y, float* ws,
                                                     long long rows, int c, int groups, float eps, int silu) {
  extern __shared__ float sh[];  // acc 2c, then mean_c, inv_c
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x, bi = blockIdx.y, blk = blockIdx.x;
  const long long r0 = rows * blk / nb, r1 = rows * (blk + 1) / nb;
  const long long base = (long long)bi * rows * c;
  float* partials = ws + (long long)bi * nb * 2 * c;
  float* totals = ws + (long long)gridDim.y * nb * 2 * c + (long long)bi * 2 * c;

  // phase 0: this block's partial moments
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();
  row_moments<T>(x + base, r0, r1, c, sh);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * c; i += blockDim.x) partials[(long long)blk * 2 * c + i] = sh[i];
  grid.sync();

  // phase 1: the sample's blocks share the reduction over their partials
  for (int m = blk * blockDim.x + threadIdx.x; m < 2 * c; m += nb * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < nb; ++k) s += partials[(long long)k * 2 * c + m];
    totals[m] = s;
  }
  grid.sync();

  // phase 2: group statistics (single-pass variance, clamped at 0), apply
  float* mean_c = sh + 2 * c;
  float* inv_c = mean_c + c;
  const int cg_ = c / groups;
  const float n = (float)rows * (float)cg_;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < cg_; ++j) {
      s1 += totals[g * cg_ + j];
      s2 += totals[c + g * cg_ + j];
    }
    const float mean = s1 / n;
    const float var = fmaxf(s2 / n - mean * mean, 0.f);
    const float inv = rsqrtf(var + eps);
    for (int j = 0; j < cg_; ++j) {
      mean_c[g * cg_ + j] = mean;
      inv_c[g * cg_ + j] = inv;
    }
  }
  __syncthreads();
  apply_rows<T>(x + base, y + base, r0, r1, c, mean_c, inv_c, scale, bias, silu);
}

template <typename T>
int big_grid(int B, long long rows, int c) {
  const int threads = block_threads(c);
  const size_t smem = (size_t)4 * c * sizeof(float);
  int per_sm = 0, sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_big_kernel<T>, threads, smem) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  long long nb = (long long)per_sm * sms / B;
  if (nb > rows) nb = rows;
  return nb < 1 ? -1 : (int)nb;
}

}  // namespace

// K9 phase 1. x (n, rows, c) contiguous bf16 / f32; ws (n, split, 2c) f32.
extern "C" int gn_row_moments(const void* x, void* ws, int n, long long rows, int c, int split, int is_bf16,
                              void* stream) {
  if (c % 2 != 0 || split < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(split, n);
  const int threads = block_threads(c);
  const size_t smem = (size_t)2 * c * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    gn_row_moments_kernel<bf16><<<grid, threads, smem, s>>>((const bf16*)x, (float*)ws, rows, c, split);
  else
    gn_row_moments_kernel<float><<<grid, threads, smem, s>>>((const float*)x, (float*)ws, rows, c, split);
  RETURN_IF_ERR();
  return 0;
}

// K9 phase 2. stats (n / t, 2, c) f32: per-channel mean, then inverse std;
// scale, bias (c,) f32; y like x.
extern "C" int gn_apply_stats(const void* x, const void* stats, const void* scale, const void* bias, void* y, int n,
                              long long rows, int c, int t, int split, int silu, int is_bf16, void* stream) {
  if (c % 2 != 0 || split < 1 || t < 1 || n % t != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(split, n);
  const size_t smem = (size_t)2 * c * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    gn_apply_stats_kernel<bf16><<<grid, 256, smem, s>>>((const bf16*)x, (const float*)stats, (const float*)scale,
                                                         (const float*)bias, (bf16*)y, rows, c, t, split, silu);
  else
    gn_apply_stats_kernel<float><<<grid, 256, smem, s>>>((const float*)x, (const float*)stats, (const float*)scale,
                                                          (const float*)bias, (float*)y, rows, c, t, split, silu);
  RETURN_IF_ERR();
  return 0;
}

// K10's blocks per sample (the grid's x): every block of the cooperative
// launch resident at once, at most one block per row; < 0 when B samples
// do not fit. The caller sizes ws as B * (nb + 1) * 2c floats.
extern "C" int gn_big_blocks(int B, long long rows, int c, int is_bf16) {
  if (c % 2 != 0 || B < 1) return -1;
  return is_bf16 ? big_grid<bf16>(B, rows, c) : big_grid<float>(B, rows, c);
}

// K10. x, y (B, rows, c) contiguous; scale, bias (c,) f32; ws as above.
extern "C" int gn_big(const void* x, const void* scale, const void* bias, void* y, void* ws, int B, int nb,
                      long long rows, int c, int groups, float eps, int silu, int is_bf16, void* stream) {
  if (c % 2 != 0 || c % groups != 0 || nb < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(nb, B);
  const int threads = block_threads(c);
  const size_t smem = (size_t)4 * c * sizeof(float);
  void* args[] = {(void*)&x, (void*)&scale, (void*)&bias, (void*)&y, (void*)&ws, (void*)&rows, (void*)&c,
                  (void*)&groups, (void*)&eps, (void*)&silu};
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    cudaLaunchCooperativeKernel((const void*)gn_big_kernel<bf16>, grid, threads, args, smem, s);
  else
    cudaLaunchCooperativeKernel((const void*)gn_big_kernel<float>, grid, threads, args, smem, s);
  RETURN_IF_ERR();
  return 0;
}
