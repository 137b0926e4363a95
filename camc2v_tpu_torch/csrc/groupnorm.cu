// K1: GroupNorm(+SiLU) over channels-last (N, S, C) maps.
//
// Replaces the Pallas kernel camc2v_tpu/ops/groupnorm.py::_gn_kernel
// (entry group_norm_fused). Statistics are f32, per (sample, group), over all
// S rows and the group's C/G channels, with the exact two-pass variance.
//
// Bound on the H100 by HBM bytes (three reads of x, one write of y; no
// matmul). A TPU grid step held one whole sample in VMEM; here each sample's
// rows are split over `split` blocks so the card stays busy at every shape
// (UNet maps of 1K-16K rows, VAE maps of 64K rows). Threads own channel pairs
// (bf16x2 / float2 loads; consecutive threads read consecutive words of a
// row), so every row is read coalesced. Three launches:
//   gn_stats<0>  per-(n, split, group) sums of x           -> ws[0]
//   gn_stats<1>  per-(n, split, group) sums of (x - mean)^2 -> ws[1]
//   gn_apply     y = ((x - mean) * rsqrt(var + eps)) * scale + bias [, SiLU]
// Each later launch re-reduces the small partial arrays itself.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

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

// group means (PHASE 1) or means and inverse std (apply) from the partials
__device__ void group_stats(const float* ws, int n, int ni, int split, int groups, float count,
                            float eps, float* mean_g, float* inv_g) {
  const float* sums = ws + (long long)ni * split * groups;
  const float* sqs = ws + (long long)n * split * groups + (long long)ni * split * groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.f, q = 0.f;
    for (int k = 0; k < split; ++k) {
      s += sums[k * groups + g];
      if (inv_g) q += sqs[k * groups + g];
    }
    mean_g[g] = s / count;
    if (inv_g) inv_g[g] = rsqrtf(q / count + eps);
  }
}

template <typename T, int PHASE>
__global__ void __launch_bounds__(THREADS) gn_stats(const T* __restrict__ x, float* ws, int n,
                                                    long long rows, int c, int groups, int split) {
  extern __shared__ float sh[];
  float* ch_acc = sh;         // c
  float* mean_g = sh + c;     // groups
  const int ni = blockIdx.y, si = blockIdx.x;
  const long long r0 = rows * si / split, r1 = rows * (si + 1) / split;
  const int cg = c / groups;
  const T* xs = x + (long long)ni * rows * c;
  for (int i = threadIdx.x; i < c; i += blockDim.x) ch_acc[i] = 0.f;
  if (PHASE == 1) group_stats(ws, n, ni, split, groups, (float)rows * cg, 0.f, mean_g, nullptr);
  __syncthreads();
  const int pairs = c / 2;
  const int tpr = pairs < THREADS ? pairs : THREADS;
  const int rgroups = THREADS / tpr;
  const int rg = threadIdx.x / tpr, lane = threadIdx.x % tpr;
  if (rg < rgroups) {
    for (int p = lane; p < pairs; p += tpr) {
      float m0 = 0.f, m1 = 0.f;
      if (PHASE == 1) {
        m0 = mean_g[(2 * p) / cg];
        m1 = mean_g[(2 * p + 1) / cg];
      }
      float s0 = 0.f, s1 = 0.f;
      for (long long r = r0 + rg; r < r1; r += rgroups) {
        float2 v = load2<T>(xs + r * c + 2 * p);
        if (PHASE == 0) {
          s0 += v.x;
          s1 += v.y;
        } else {
          float d0 = v.x - m0, d1 = v.y - m1;
          s0 += d0 * d0;
          s1 += d1 * d1;
        }
      }
      atomicAdd(&ch_acc[2 * p], s0);
      atomicAdd(&ch_acc[2 * p + 1], s1);
    }
  }
  __syncthreads();
  float* out = ws + (long long)PHASE * n * split * groups + ((long long)ni * split + si) * groups;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += ch_acc[g * cg + j];
    out[g] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gn_apply(const T* __restrict__ x, const float* __restrict__ scale,
                                                    const float* __restrict__ bias, T* __restrict__ y,
                                                    const float* ws, int n, long long rows, int c,
                                                    int groups, int split, float eps, int silu) {
  extern __shared__ float sh[];
  float* mean_g = sh;
  float* inv_g = sh + groups;
  const int ni = blockIdx.y, si = blockIdx.x;
  const int cg = c / groups;
  group_stats(ws, n, ni, split, groups, (float)rows * cg, eps, mean_g, inv_g);
  __syncthreads();
  const long long r0 = rows * si / split, r1 = rows * (si + 1) / split;
  const int pairs = c / 2;
  const long long base = (long long)ni * rows * c;
  const long long total = (r1 - r0) * pairs;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const long long r = r0 + i / pairs;
    const int c0 = 2 * (int)(i % pairs);
    const long long off = base + r * c + c0;
    float2 v = load2<T>(x + off);
    const int g0 = c0 / cg, g1 = (c0 + 1) / cg;
    float a = (v.x - mean_g[g0]) * inv_g[g0];
    float b = (v.y - mean_g[g1]) * inv_g[g1];
    a = a * scale[c0] + bias[c0];
    b = b * scale[c0 + 1] + bias[c0 + 1];
    if (silu) {
      a = a * (1.f / (1.f + expf(-a)));
      b = b * (1.f / (1.f + expf(-b)));
    }
    store2<T>(y + off, a, b);
  }
}

template <typename T>
int launch(const void* x, const void* scale, const void* bias, void* y, void* ws, int n,
           long long rows, int c, int groups, int split, float eps, int silu, cudaStream_t s) {
  dim3 grid(split, n);
  size_t sm_stats = (size_t)(c + groups) * sizeof(float);
  gn_stats<T, 0><<<grid, THREADS, sm_stats, s>>>((const T*)x, (float*)ws, n, rows, c, groups, split);
  RETURN_IF_ERR();
  gn_stats<T, 1><<<grid, THREADS, sm_stats, s>>>((const T*)x, (float*)ws, n, rows, c, groups, split);
  RETURN_IF_ERR();
  gn_apply<T><<<grid, THREADS, 2 * groups * sizeof(float), s>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)y, (const float*)ws, n, rows, c,
      groups, split, eps, silu);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

extern "C" int gn_forward(const void* x, const void* scale, const void* bias, void* y, void* ws,
                          int n, long long rows, int c, int groups, int split, float eps, int silu,
                          int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) return launch<bf16>(x, scale, bias, y, ws, n, rows, c, groups, split, eps, silu, s);
  return launch<float>(x, scale, bias, y, ws, n, rows, c, groups, split, eps, silu, s);
}
