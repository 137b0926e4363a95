// K9 and K10: GroupNorm(+SiLU) with statistics per (sample, group) over a
// long sequence of frames, from f32 raw moments with the single-pass
// variance max(E[x^2] - E[x]^2, 0).
//
// K9 replaces the Pallas kernels camc2v_tpu/ops/groupnorm.py::
// _gn_row_moments_kernel + _gn_apply_kernel (entry group_norm_fused_temporal).
// x is viewed as (B, rows, C), rows = T*HW per sample. One C entry
// (gn_temporal) launches two kernels and nothing between them:
//   moments  each block sums its slice of one sample's rows (the plan of
//            ops/groupnorm.py::temporal_plan: `splits` slices a sample, a
//            block of `rgroups` row groups x C/VEC threads, each thread a
//            16-byte piece of VEC channels of every rgroups-th row, in row
//            order), meets its row groups in shared memory in a fixed order,
//            folds the channels into their groups and writes (2, G) partial
//            sums to the workspace; then it takes a ticket on its sample's
//            arrival counter (__threadfence, atomicAdd). The last block of a
//            sample sums the sample's partials in slice order (bit-identical
//            from run to run, whichever block arrives last), forms the
//            groups' mean and inverse std, writes them per channel as
//            (B, 2, C) stats and resets the counter for the next call.
//   apply    the same slices: y = (x - mean) * inv * scale + bias [, SiLU],
//            each thread's channel constants in registers, 16-byte loads and
//            stores.
// The TPU ran the combine as a dozen small XLA ops on a (B, 2, C) array
// between its two kernels; here it is the moments launch's last block, so
// the host enqueues two launches per call and no other op.
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
// Bound by HBM bytes: x is read twice (moments, apply; the second read
// partly from L2) and y written once. K9's grid is one wave sized from the
// SM count (two blocks of up to 256 threads an SM, as many as the apply
// kernel's registers let share one; each thread keeps four 16-byte loads
// in flight); no single f32 running sum spans more than one thread's share
// of a slice.
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

// ---------------------------------------------------------------- K9

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

// K9's moments launch, grid (splits, B), (C / VEC) * rgroups threads: thread
// (rg, p) sums piece p of rows r0 + rg, r0 + rg + rgroups, ... of its
// block's slice [r0, r1) in row order. ws (B, splits, 2, G) holds the
// slices' group partials; the sample's last block writes stats (B, 2, C).
template <typename T>
__global__ void __launch_bounds__(512)
gn_moments_kernel(const T* __restrict__ x, float* __restrict__ ws, float* __restrict__ stats,
                  unsigned int* __restrict__ counters, long long rows, int c, int groups, int splits, int rgroups,
                  float count, float eps) {
  constexpr int VEC = Piece<T>::VEC;
  extern __shared__ float red[];  // (rgroups, 2, c); then the combine's (nparts, 2G) sums
  __shared__ int last;
  const int pieces = c / VEC;
  const int tid = threadIdx.x, rg = tid / pieces, p = tid % pieces;
  const int si = blockIdx.x, b = blockIdx.y;
  const long long r0 = rows * si / splits, r1 = rows * (si + 1) / splits;
  const T* xs = x + (long long)b * rows * c + p * VEC;

  float s[VEC], q[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.f;
  long long r = r0 + rg;
  for (; r + (K9_UNROLL - 1) * rgroups < r1; r += K9_UNROLL * rgroups) {
    float v[K9_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < K9_UNROLL; ++u) Piece<T>::load(xs + (r + u * rgroups) * c, v[u]);
#pragma unroll
    for (int u = 0; u < K9_UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s[j] += v[u][j];
        q[j] += v[u][j] * v[u][j];
      }
    }
  }
  for (; r < r1; r += rgroups) {
    float v[VEC];
    Piece<T>::load(xs + r * c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      s[j] += v[j];
      q[j] += v[j] * v[j];
    }
  }
  float* mine = red + (long long)rg * 2 * c + p * VEC;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mine[j] = s[j];
    mine[c + j] = q[j];
  }
  __syncthreads();

  // the slice's partial per (moment m, group g): over the row groups, then
  // the group's channels, each in order
  const int cg_ = c / groups, vals = 2 * groups;
  float* part = ws + ((long long)b * splits + si) * vals;
  for (int v = tid; v < vals; v += blockDim.x) {
    const int m = v / groups, g = v % groups;
    float acc = 0.f;
    for (int ch = g * cg_; ch < (g + 1) * cg_; ++ch) {
      float t = 0.f;
      for (int k = 0; k < rgroups; ++k) t += red[((long long)k * 2 + m) * c + ch];
      acc += t;
    }
    part[v] = acc;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[b], 1u) == (unsigned int)(splits - 1);
  __syncthreads();
  if (!last) return;

  // the sample's last block: its slices' partials summed in slice order (in
  // nparts contiguous ranges, then the ranges in order), the groups' mean
  // and inverse std, per channel
  __threadfence();
  const int nparts = (int)blockDim.x / vals > 1 ? (int)blockDim.x / vals : 1;
  const float* parts = ws + (long long)b * splits * vals;
  for (int i = tid; i < vals * nparts; i += blockDim.x) {
    const int v = i % vals, pi = i / vals;
    const int k0 = (int)((long long)splits * pi / nparts), k1 = (int)((long long)splits * (pi + 1) / nparts);
    float acc = 0.f;
#pragma unroll 8
    for (int k = k0; k < k1; ++k) acc += __ldcg(parts + (long long)k * vals + v);
    red[i] = acc;
  }
  __syncthreads();
  float* st = stats + (long long)b * 2 * c;
  for (int g = tid; g < groups; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int pi = 0; pi < nparts; ++pi) {
      s1 += red[pi * vals + g];
      s2 += red[pi * vals + groups + g];
    }
    const float mean = s1 / count;
    const float inv = rsqrtf(fmaxf(s2 / count - mean * mean, 0.f) + eps);
    for (int ch = g * cg_; ch < (g + 1) * cg_; ++ch) {
      st[ch] = mean;
      st[c + ch] = inv;
    }
  }
  if (tid == 0) counters[b] = 0u;
}

template <int VEC, bool SILU>
__device__ __forceinline__ void normalise(float (&v)[VEC], const float (&mean)[VEC], const float (&inv)[VEC],
                                          const float (&sc)[VEC], const float (&bi)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float a = (v[j] - mean[j]) * inv[j];
    a = a * sc[j] + bi[j];
    v[j] = SILU ? a * (1.f / (1.f + expf(-a))) : a;
  }
}

// K9's apply launch over the moments launch's slices and threads
template <typename T, bool SILU>
__global__ void __launch_bounds__(512)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y, long long rows, int c, int splits, int rgroups) {
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

template <typename T>
int launch_temporal(const void* x, const void* scale, const void* bias, void* y, void* ws, void* stats,
                    void* counters, int B, long long rows, int c, int groups, int splits, int rgroups, float eps,
                    int silu, cudaStream_t s) {
  const dim3 grid(splits, B);
  const int threads = c / Piece<T>::VEC * rgroups;
  const size_t smem = (size_t)rgroups * 2 * c * sizeof(float);
  const float count = (float)((double)rows * (c / groups));
  gn_moments_kernel<T><<<grid, threads, smem, s>>>((const T*)x, (float*)ws, (float*)stats, (unsigned int*)counters,
                                                  rows, c, groups, splits, rgroups, count, eps);
  RETURN_IF_ERR();
  if (silu)
    gn_apply_kernel<T, true><<<grid, threads, 0, s>>>((const T*)x, (const float*)stats, (const float*)scale,
                                                     (const float*)bias, (T*)y, rows, c, splits, rgroups);
  else
    gn_apply_kernel<T, false><<<grid, threads, 0, s>>>((const T*)x, (const float*)stats, (const float*)scale,
                                                      (const float*)bias, (T*)y, rows, c, splits, rgroups);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

// K9: the moments launch, then the apply launch, on `stream`. x, y
// (B, rows, c) contiguous bf16 or f32 on 16-byte boundaries, c a multiple of
// a 16-byte piece's channels (8 bf16, 4 f32) and of `groups`; scale, bias
// (c,) f32; ws (B, splits, 2, groups) and stats (B, 2, c) f32 scratch;
// counters (B,) uint32, zero before the first call (every call leaves them
// zero). splits and rgroups: the plan (ops/groupnorm.py::temporal_plan).
extern "C" int gn_temporal(const void* x, const void* scale, const void* bias, void* y, void* ws, void* stats,
                           void* counters, int B, long long rows, int c, int groups, int splits, int rgroups,
                           float eps, int silu, int is_bf16, void* stream) {
  const int vec = is_bf16 ? Piece<bf16>::VEC : Piece<float>::VEC;
  if (B < 1 || groups < 1 || c % vec != 0 || c % groups != 0 || splits < 1 || rgroups < 1 ||
      c / vec * rgroups > 512 || (size_t)rgroups * 2 * c * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_temporal<bf16>(x, scale, bias, y, ws, stats, counters, B, rows, c, groups, splits, rgroups,
                                         eps, silu, s)
                 : launch_temporal<float>(x, scale, bias, y, ws, stats, counters, B, rows, c, groups, splits,
                                          rgroups, eps, silu, s);
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
