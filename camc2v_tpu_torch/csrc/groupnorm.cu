// K1: GroupNorm(+SiLU) over channels-last (N, rows, C) maps.
//
// Replaces the Pallas kernel camc2v_tpu/ops/groupnorm.py::_gn_kernel
// (entry group_norm_fused). Statistics are f32, per (sample, group), over
// all rows and the group's C/G channels, with the exact two-pass variance;
// then scale, bias and the optional SiLU, the output in x's dtype.
//
// Bound on the H100 by HBM bytes: x read once and y written once is the
// least. A TPU grid step held one whole sample in VMEM; here a sample's rows
// are cut into slices (rows * s / slices, the plan of
// ops/groupnorm.py::norm_plan), each held in one block's shared memory:
// the block brings its slice in with bulk copies (CHUNKS of them, each on
// its own mbarrier, so the first pass starts on the first chunk), then
// runs a local two-pass over it: thread (rg, p) of rgroups x (C / VEC)
// threads sums its 16-byte piece p of every rgroups-th row; the row groups
// and the group's channels (a piece may straddle two groups) meet in a
// warp per group, in a fixed order, giving the slice's group sums and
// means; the second pass sums the squared deviations from the slice's own
// group means. Each slice gives (count, sum, mean, M2) per group, and the
// slices merge by Chan's formula in a fixed order,
// mean = sum sum_i / n, M2 = sum (M2_i + n_i (mean_i - mean)^2), so the
// result is the same bits on every run. Two paths:
//   gn_cluster_kernel   one launch: a cluster of `slices` blocks (<= 8)
//                       holds one sample; each block writes its slice's
//                       statistics into every block's shared memory
//                       (distributed shared memory), one cluster barrier,
//                       then every block merges the slices in rank order and
//                       normalises its own slice from shared memory. x is
//                       read once.
//   gn_stats_kernel +   two launches, for samples larger than a cluster
//   gn_norm_apply_kernel holds: the statistics launch writes each slice's
//                       statistics and its sample's last block (a ticket
//                       after __threadfence) merges them into per-channel
//                       (mean, inverse std); the apply launch (K9's,
//                       gn_pieces.cuh) normalises, reading x again, from L2
//                       where the map fits it.
// Every per-thread constant (its channels' groups, the fold's lanes) is
// worked out once; the loops hold no integer division.
#include <cooperative_groups.h>

#include "gn_pieces.cuh"
#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS_MAX = 512;    // a block's most threads (ops/groupnorm.py::K1_THREADS)
constexpr int CHUNKS = 8;           // bulk copies per slice (ops/groupnorm.py::K1_CHUNKS)
constexpr int MAX_CLUSTER = 8;      // a cluster's most blocks (ops/groupnorm.py::K1_MAX_CLUSTER)
constexpr int SMEM_MAX = 232448;    // a block's shared memory on the H100
constexpr int STATIC_SMEM = 128;    // the kernels' own shared variables, at most (ops K1_STATIC_SMEM)

// A slice's statistics, 3 G + 1 floats: the group sums, the groups' sums of
// squared deviations from the slice's group means, those means, the count
// of the slice's rows.
__host__ __device__ inline int stat_vals(int groups) { return 3 * groups + 1; }

// one block's dynamic shared memory (ops/groupnorm.py::k1_smem): the slice,
// the row groups' per-channel sums, the slice's statistics, the cluster's
// blocks' statistics (MAX_CLUSTER of them), the merged group mean and
// inverse std (2G), the chunks' barriers
struct Layout {
  int red, part, xchg, gstat, bars, total;
};

// a launch's constants, worked out on the host
struct Params {
  int rows, c, groups, cg, pieces, rgroups, nthreads, slices, vals;
  float eps, n;  // n = rows * cg, a group's count
  Layout L;
};

Params make_params(long long rows, int c, int groups, int rgroups, int slices, int elem, float eps) {
  Params p;
  p.rows = (int)rows;
  p.c = c;
  p.groups = groups;
  p.cg = c / groups;
  p.pieces = c * elem / 16;
  p.rgroups = rgroups;
  p.nthreads = rgroups * p.pieces;
  p.slices = slices;
  p.vals = stat_vals(groups);
  p.eps = eps;
  p.n = (float)rows * (float)p.cg;
  const long long max_rows = (rows + slices - 1) / slices;
  Layout& l = p.L;
  l.red = (int)(max_rows * c * elem);  // c * elem is a multiple of 16
  l.part = l.red + rgroups * c * (int)sizeof(float);
  l.xchg = l.part + p.vals * (int)sizeof(float);
  l.gstat = l.xchg + MAX_CLUSTER * p.vals * (int)sizeof(float);
  l.bars = (l.gstat + 2 * groups * (int)sizeof(float) + 7) / 8 * 8;
  l.total = l.bars + CHUNKS * (int)sizeof(uint64_t);
  return p;
}

__device__ __forceinline__ int slice_begin(const Params& P, int s) { return P.rows * s / P.slices; }

// A thread's constants: its channel piece p, its VEC channels' groups, and
// its lane's share of a group's (row group, channel) values in the fold:
// row groups rg0, rg0 + rstep, ... and channels ch, ch + cstep, ... < cg
struct Thread {
  int p, g[8], rg0, rstep, ch, cstep;
};
template <int VEC>
__device__ __forceinline__ Thread thread_consts(const Params& P) {
  Thread t;
  const int cg_ = P.cg, lane = threadIdx.x % 32;
  t.p = threadIdx.x % P.pieces;
  const int c0 = t.p * VEC;
  int g = c0 / cg_, next = (g + 1) * cg_;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    if (c0 + j >= next) {
      ++g;
      next += cg_;
    }
    t.g[j] = g;
  }
  if (cg_ <= 32) {  // lanes (row group, channel): 32 / cg row groups at once
    t.rstep = 32 / cg_;
    t.ch = lane % cg_;
    t.rg0 = lane < t.rstep * cg_ ? lane / cg_ : P.rgroups;
    t.cstep = cg_;
  } else {  // lanes over the channels, every row group
    t.rstep = 1;
    t.ch = lane;
    t.rg0 = 0;
    t.cstep = 32;
  }
  return t;
}

// per-channel sums of the block's threads (red: rgroups x c, thread tid's
// VEC channels at tid * VEC) folded into one value per group: warp w of
// the full warps takes groups w, w + nwarps, ...; each lane sums its share
// of the group's values in order and the lanes meet by a shuffle tree.
// sum[g] gets the total; mean[g], where given, the total over n.
__device__ __forceinline__ void fold_groups(const float* red, const Thread& t, float* sum, float* mean, float n,
                                            const Params& P) {
  __syncthreads();
  const int warp = threadIdx.x / 32, nwarps = P.nthreads / 32;
  if (warp < nwarps) {
    for (int g = warp; g < P.groups; g += nwarps) {
      float s = 0.f;
      for (int rg = t.rg0; rg < P.rgroups; rg += t.rstep)
        for (int ch = t.ch; ch < P.cg; ch += t.cstep) s += red[rg * P.c + g * P.cg + ch];
      s = warp_sum(s);
      if (threadIdx.x % 32 == 0) {
        sum[g] = s;
        if (mean) mean[g] = s / n;
      }
    }
  }
  __syncthreads();
}

// The block's slice [r0, r1) of sample b into shared memory (xs), and its
// local two-pass statistics into part (stat_vals): part[g] the group sums,
// part[G + g] the sums of squared deviations from part[2G + g], the slice's
// group means, part[3G] the slice's row count.
template <typename T>
__device__ __forceinline__ void slice_stats(const T* __restrict__ x, unsigned char* smem, const Params& P,
                                            const Thread& t, int r0, int r1, int b) {
  constexpr int VEC = Piece<T>::VEC;
  const T* xs = reinterpret_cast<const T*>(smem);
  float* red = reinterpret_cast<float*>(smem + P.L.red);
  float* part = reinterpret_cast<float*>(smem + P.L.part);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + P.L.bars);
  const int tid = threadIdx.x, c = P.c, nthreads = P.nthreads;
  const int nrows = r1 - r0;
  const int chunk_rows = (nrows + CHUNKS - 1) / CHUNKS;
  if (tid < CHUNKS) {  // lane q of warp 0: chunk q's barrier, then its copy
    sm90::mbar_init(&bars[tid], 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if (tid < CHUNKS) {
    const int a = min(nrows, tid * chunk_rows), e = min(nrows, (tid + 1) * chunk_rows);
    const uint32_t bytes = (uint32_t)(e - a) * (uint32_t)(c * sizeof(T));
    sm90::mbar_expect_tx(&bars[tid], bytes);
    if (bytes)
      sm90::bulk_load((void*)(xs + (long long)a * c), x + ((long long)b * P.rows + r0 + a) * c, bytes, &bars[tid]);
  }

  // pass 1: thread tid's flat pieces tid, tid + nthreads, ... (its channel
  // piece p, rows tid / pieces + i * rgroups), chunk by chunk, each waited
  // for before its first piece
  const int nflat = nrows * P.pieces, chunk_flat = chunk_rows * P.pieces;
  float s[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s[j] = 0.f;
  int f = tid;
  for (int q = 0; q < CHUNKS && f < nflat; ++q) {
    const int end = min(nflat, (q + 1) * chunk_flat);
    if (f >= end) continue;
    sm90::mbar_wait(&bars[q], 0);
#pragma unroll 4
    for (; f < end; f += nthreads) {
      float v[VEC];
      Piece<T>::load(xs + f * VEC, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s[j] += v[j];
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[tid * VEC + j] = s[j];
  fold_groups(red, t, part, part + 2 * P.groups, (float)nrows * (float)P.cg, P);

  // pass 2: squared deviations from the slice's group means
  float m[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = part[2 * P.groups + t.g[j]];
    s[j] = 0.f;
  }
#pragma unroll 4
  for (f = tid; f < nflat; f += nthreads) {
    float v[VEC];
    Piece<T>::load(xs + f * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float d = v[j] - m[j];
      s[j] += d * d;
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) red[tid * VEC + j] = s[j];
  if (tid == 0) part[3 * P.groups] = (float)nrows;
  fold_groups(red, t, part + P.groups, nullptr, 0.f, P);
}

// Chan's merge of a sample's `slices` statistics (P.vals floats each, in
// shared memory or, GLOBAL, in device memory) into gstat (group mean, then
// inverse std): lane g of warp w reads group g of slices w, w + nwarps, ...
// in order (a warp's loads are one coalesced row), the warps' partials
// meet in `acc` (nwarps x G floats of shared memory) in warp order; first
// the sums, then the M2 terms about the group means.
template <bool GLOBAL>
__device__ __forceinline__ void merge_slices(const float* st, float* acc, float* gstat, const Params& P) {
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32, nwarps = P.nthreads / 32, G = P.groups;
  const bool mine = warp < nwarps && g < G;
  auto ld = [](const float* p) { return GLOBAL ? __ldcg(p) : *p; };
  if (mine) {
    float sum = 0.f;
#pragma unroll 4
    for (int k = warp; k < P.slices; k += nwarps) sum += ld(st + k * P.vals + g);
    acc[warp * G + g] = sum;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float sum = 0.f;
    for (int w = 0; w < nwarps; ++w) sum += acc[w * G + threadIdx.x];
    gstat[threadIdx.x] = sum / P.n;
  }
  __syncthreads();
  if (mine) {
    const float mean = gstat[g];
    float m2 = 0.f;
#pragma unroll 4
    for (int k = warp; k < P.slices; k += nwarps) {
      const float* sk = st + k * P.vals;
      const float d = ld(sk + 2 * G + g) - mean;
      m2 += ld(sk + G + g) + ld(sk + 3 * G) * (float)P.cg * d * d;
    }
    acc[warp * G + g] = m2;
  }
  __syncthreads();
  if (threadIdx.x < G) {
    float m2 = 0.f;
    for (int w = 0; w < nwarps; ++w) m2 += acc[w * G + threadIdx.x];
    gstat[G + threadIdx.x] = rsqrtf(m2 / P.n + P.eps);
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait;" ::: "memory"); }

// One launch: grid (slices, N), a cluster of `slices` blocks per sample.
template <typename T, bool SILU>
__global__ void __launch_bounds__(THREADS_MAX, 2)
gn_cluster_kernel(const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ bias,
                  T* __restrict__ y, const __grid_constant__ Params P) {
  constexpr int VEC = Piece<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started: its shared memory may be written from here on
  const int si = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int r0 = slice_begin(P, si), r1 = slice_begin(P, si + 1);
  const Thread t = thread_consts<VEC>(P);
  slice_stats<T>(x, smem, P, t, r0, r1, b);
  const float* part = reinterpret_cast<const float*>(smem + P.L.part);
  float* xchg = reinterpret_cast<float*>(smem + P.L.xchg);
  float* gstat = reinterpret_cast<float*>(smem + P.L.gstat);

  // the slice's statistics into xchg[si] of every block of the cluster (warp
  // j writes block j's), then one cluster barrier; no block touches
  // another's shared memory after it
  const int c0 = t.p * VEC, warp = tid / 32;
  float sc[VEC], bi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sc[j] = __ldg(scale + c0 + j);
    bi[j] = __ldg(bias + c0 + j);
  }
  cluster_wait();  // every block of the cluster has started
  if (warp < P.slices) {
    float* dst = cluster.map_shared_rank(xchg, warp) + si * P.vals;
    for (int v = tid % 32; v < P.vals; v += 32) dst[v] = part[v];
  }
  cluster.sync();

  // the merge, in every block alike
  merge_slices<false>(xchg, reinterpret_cast<float*>(smem + P.L.red), gstat, P);
  __syncthreads();

  // apply, from shared memory
  float mean[VEC], inv[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    mean[j] = gstat[t.g[j]];
    inv[j] = gstat[P.groups + t.g[j]];
  }
  const T* xs = reinterpret_cast<const T*>(smem);
  T* ys = y + ((long long)b * P.rows + r0) * P.c;
  const int nflat = (r1 - r0) * P.pieces;
#pragma unroll 2
  for (int f = tid; f < nflat; f += P.nthreads) {
    float v[VEC];
    Piece<T>::load(xs + f * VEC, v);
    normalise<VEC, SILU>(v, mean, inv, sc, bi);
    Piece<T>::store(ys + f * VEC, v);
  }
}

// Two launches, the first: grid (slices, N). ws (N, slices, vals) holds
// the slices' statistics; the sample's last block writes stats (N, 2, C).
template <typename T>
__global__ void __launch_bounds__(THREADS_MAX, 2)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ ws, float* __restrict__ stats,
                unsigned int* __restrict__ counters, const __grid_constant__ Params P) {
  constexpr int VEC = Piece<T>::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int si = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const Thread t = thread_consts<VEC>(P);
  slice_stats<T>(x, smem, P, t, slice_begin(P, si), slice_begin(P, si + 1), b);
  const float* part = reinterpret_cast<const float*>(smem + P.L.part);
  float* gstat = reinterpret_cast<float*>(smem + P.L.gstat);
  float* mine = ws + ((long long)b * P.slices + si) * P.vals;
  for (int i = tid; i < P.vals; i += P.nthreads) mine[i] = part[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[b], 1u) == (unsigned int)(P.slices - 1);
  __syncthreads();
  if (!last) return;

  // the sample's last block: the merge, then the stats per channel
  __threadfence();
  merge_slices<true>(ws + (long long)b * P.slices * P.vals, reinterpret_cast<float*>(smem + P.L.red), gstat, P);
  __syncthreads();
  float* st = stats + (long long)b * 2 * P.c;
  for (int ch = tid; ch < P.c; ch += P.nthreads) {
    st[ch] = gstat[ch / P.cg];
    st[P.c + ch] = gstat[P.groups + ch / P.cg];
  }
  if (tid == 0) counters[b] = 0u;
}

// Two launches, the second: K9's apply over (apply_splits, N) blocks.
template <typename T, bool SILU>
__global__ void __launch_bounds__(512)
gn_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y, long long rows, int c, int splits,
                     int rgroups) {
  apply_slice<T, SILU>(x, stats, scale, bias, y, rows, c, splits, rgroups);
}

// kernel K's dynamic shared memory raised to the card's most beside its
// static shared memory, once per library
template <auto K>
cudaError_t allow_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, K);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX - (int)attr.sharedSizeBytes);
  done = e == cudaSuccess;
  return e;
}

template <typename T>
cudaLaunchConfig_t cluster_config(int n, const Params& P, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.slices, n);
  cfg.blockDim = dim3(P.nthreads);
  cfg.dynamicSmemBytes = P.L.total;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = P.slices;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, bool SILU>
cudaError_t launch_cluster(const void* x, const void* scale, const void* bias, void* y, int n, const Params& P,
                           cudaStream_t s) {
  cudaError_t e = allow_smem<gn_cluster_kernel<T, SILU>>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<T>(n, P, s, &attr);
  return cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, SILU>, (const T*)x, (const float*)scale, (const float*)bias,
                            (T*)y, P);
}

// a plan the kernels take: whole 16-byte pieces, at most THREADS_MAX
// threads of whole warps enough for the fold, the shared memory
bool takes(int n, long long rows, int c, int groups, int cluster, int slices, int rgroups, int elem) {
  const int pieces = c * elem / 16;
  if (n < 1 || rows < 1 || groups < 1 || c * elem % 16 != 0 || c % groups != 0 || slices < 1 || slices > rows ||
      rows * slices >= (1LL << 31) || rgroups < 1 || rgroups * pieces > THREADS_MAX ||
      groups > 32 || rgroups * pieces < 32 || (cluster && slices > MAX_CLUSTER))
    return false;
  return make_params(rows, c, groups, rgroups, slices, elem, 0.f).L.total + STATIC_SMEM <= SMEM_MAX;
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, void* ws, void* stats, void* counters, int n,
           long long rows, int c, int groups, int cluster, int slices, int rgroups, int apply_splits,
           int apply_rgroups, float eps, int silu, cudaStream_t s) {
  if (!takes(n, rows, c, groups, cluster, slices, rgroups, sizeof(T))) return (int)cudaErrorInvalidValue;
  const Params P = make_params(rows, c, groups, rgroups, slices, sizeof(T), eps);
  if (cluster) {
    const cudaError_t e = silu ? launch_cluster<T, true>(x, scale, bias, y, n, P, s)
                               : launch_cluster<T, false>(x, scale, bias, y, n, P, s);
    if (e != cudaSuccess) return (int)e;
    RETURN_IF_ERR();
    return 0;
  }
  if (apply_splits < 1 || apply_rgroups < 1 || apply_rgroups * P.pieces > 512) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem<gn_stats_kernel<T>>();
  if (e != cudaSuccess) return (int)e;
  gn_stats_kernel<T><<<dim3(slices, n), P.nthreads, P.L.total, s>>>((const T*)x, (float*)ws, (float*)stats,
                                                                      (unsigned int*)counters, P);
  RETURN_IF_ERR();
  const dim3 grid(apply_splits, n);
  if (silu)
    gn_norm_apply_kernel<T, true><<<grid, apply_rgroups * P.pieces, 0, s>>>(
        (const T*)x, (const float*)stats, (const float*)scale, (const float*)bias, (T*)y, rows, c, apply_splits,
        apply_rgroups);
  else
    gn_norm_apply_kernel<T, false><<<grid, apply_rgroups * P.pieces, 0, s>>>(
        (const T*)x, (const float*)stats, (const float*)scale, (const float*)bias, (T*)y, rows, c, apply_splits,
        apply_rgroups);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

// K1 on `stream`. x, y (n, rows, c) contiguous bf16 or f32 on 16-byte
// boundaries, c a multiple of a 16-byte piece's channels (8 bf16, 4 f32)
// and of `groups`; scale, bias (c,) f32. The plan (ops/groupnorm.py::
// norm_plan): `cluster` (one launch, `slices` <= 8 blocks a cluster) or two
// launches (`slices` statistics blocks a sample, then the apply's
// apply_splits x apply_rgroups); rgroups row groups of c / VEC threads a
// block. Two launches only: ws (n, slices, 3 groups + 1) and stats
// (n, 2, c) f32 scratch, counters (n,) uint32, zero before the first call
// (every call leaves them zero).
extern "C" int gn_forward(const void* x, const void* scale, const void* bias, void* y, void* ws, void* stats,
                          void* counters, int n, long long rows, int c, int groups, int cluster, int slices,
                          int rgroups, int apply_splits, int apply_rgroups, float eps, int silu, int is_bf16,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch<bf16>(x, scale, bias, y, ws, stats, counters, n, rows, c, groups, cluster, slices, rgroups,
                                apply_splits, apply_rgroups, eps, silu, s)
                 : launch<float>(x, scale, bias, y, ws, stats, counters, n, rows, c, groups, cluster, slices, rgroups,
                                 apply_splits, apply_rgroups, eps, silu, s);
}

// The most clusters of the one-launch path's kernel the card runs at once
// (cudaOccupancyMaxActiveClusters) for a plan; < 0 on an error. For the
// tools: a plan with more clusters than this runs in more than one wave.
extern "C" int gn_max_active_clusters(int n, long long rows, int c, int groups, int slices, int rgroups,
                                      int is_bf16) {
  if (!takes(n, rows, c, groups, 1, slices, rgroups, is_bf16 ? 2 : 4)) return -(int)cudaErrorInvalidValue;
  const Params P = make_params(rows, c, groups, rgroups, slices, is_bf16 ? 2 : 4, 0.f);
  cudaLaunchAttribute attr;
  int clusters = 0;
  cudaError_t e;
  if (is_bf16) {
    const cudaLaunchConfig_t cfg = cluster_config<bf16>(n, P, 0, &attr);
    e = allow_smem<gn_cluster_kernel<bf16, true>>();
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, gn_cluster_kernel<bf16, true>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg = cluster_config<float>(n, P, 0, &attr);
    e = allow_smem<gn_cluster_kernel<float, true>>();
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, gn_cluster_kernel<float, true>, &cfg);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return clusters;
}
