// K9: GroupNorm(+SiLU) with statistics per (sample, group) over a
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
// K10 (camc2v_tpu/ops/groupnorm.py::_gn_big_kernel, the same function in
// one launch) runs K1's plan over the (B, T*HW, C) view (csrc/groupnorm.cu,
// ops/groupnorm.py::group_norm_fused_big).
//
// Bound by HBM bytes: x is read twice (moments, apply; the second read
// partly from L2) and y written once. The grid is one wave sized from the
// SM count (two blocks of up to 256 threads an SM, as many as the apply
// kernel's registers let share one; each thread keeps four 16-byte loads
// in flight); no single f32 running sum spans more than one thread's share
// of a slice.
#include "gn_pieces.cuh"

namespace {

// ---------------------------------------------------------------- K9

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

// K9's apply launch over the moments launch's slices and threads
template <typename T, bool SILU>
__global__ void __launch_bounds__(512)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ scale,
                const float* __restrict__ bias, T* __restrict__ y, long long rows, int c, int splits, int rgroups) {
  apply_slice<T, SILU>(x, stats, scale, bias, y, rows, c, splits, rgroups);
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
