// K3: fused short-sequence (temporal) multi-head self-attention.
//
// Replaces the Pallas kernel camc2v_tpu/ops/temporal_attention.py::_kernel
// (entry fused_temporal_mha). Per T-token sequence, in one pass:
//   [optional f32 LayerNorm]  xb = bf16(LN(x)) or bf16(x)
//   qkv = bf16(xb @ [Wq|Wk|Wv])                  (f32 accumulation)
//   o_h = bf16(softmax(q_h k_h^T * scale) v_h)   (f32 scores and softmax)
//   out = o @ Wo + bo [+ x, f32]                  -> x.dtype
// The projections run inside the kernel; only x, the weights and the output
// touch HBM.
//
// On the H100 the projections are ~95% of the FLOPs (8 C^2 per token against
// 4 T D per head), so the op is a chain of tensor-core GEMMs fed with weights
// from L2 (every block reads the same weights). The TPU kernel packed 128/T
// sequences into one 128-row tile behind a block-diagonal penalty; here a
// block of 16 warps owns R = NB * TP rows (TP = T rounded up to 16, padded
// keys masked; R * C_out <= 20480, i.e. 4 sequences at C = 320, 1 at 1280)
// and each sequence's scores are one (or four) 16x16 WMMA tiles, so no
// cross-sequence work is wasted. Per head, with weight_stream.cuh:
//   QKV   (R, 3D) = xb @ W_h^T in 64-column groups, C in slices of 64
//   attn  one warp per sequence for the scores and softmax, P V spread over
//         the warps, o_h (R, D) in shared memory
//   out   acc (R, C_out) += o_h @ Wo[:, h]^T in 32-wide chunks; the f32
//         accumulator stays in registers across all heads
// WMMA 16x16x16 bf16 with f32 accumulators. wgmma/TMA is later work.
#include "weight_stream.cuh"

using namespace nvcuda;

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int G1F = 2;  // QKV fragments per warp (R <= 128)

struct Layout {
  int R, TP, NB, ldx, ldq, ldo, lds, ldp;
  size_t xb, ring, wo, qkv, oh, s, p, stage, total;
};

__host__ __device__ inline Layout make_layout(int R, int TP, int c_in, int c_out, int d) {
  Layout L;
  L.R = R;
  L.TP = TP;
  L.NB = R / TP;
  L.ldx = c_in + 8;
  L.ldq = 3 * d + 8;
  L.ldo = d + 8;
  L.lds = TP + 4;
  L.ldp = TP + 8;
  L.xb = 0;
  L.ring = L.xb + align128((size_t)R * L.ldx * 2);
  L.wo = L.ring + align128(ws::ring_bytes());
  L.qkv = L.wo + align128(ws::chunk_bytes(c_out));
  L.oh = L.qkv + align128((size_t)R * L.ldq * 2);
  L.s = L.oh + align128((size_t)R * L.ldo * 2);
  L.p = L.s + align128((size_t)R * L.lds * 4);
  L.stage = L.p + align128((size_t)R * L.ldp * 2);
  L.total = L.stage + align128((size_t)WARPS * 256 * 4);
  return L;
}

// a warp's 16x16 f32 fragment -> bf16 at dst (row stride ld), via its staging tile
__device__ __forceinline__ void store_bf16(const ws::Acc& c, float* st, bf16* dst, int ld, int lane) {
  wmma::store_matrix_sync(st, c, 16, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) dst[(e / 16) * ld + e % 16] = __float2bfloat16(st[e]);
  __syncwarp();
}

template <int MAXF>
__global__ void __launch_bounds__(THREADS, 1)
temporal_mha_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wq, const bf16* __restrict__ wk,
                    const bf16* __restrict__ wv, const bf16* __restrict__ wo,
                    const float* __restrict__ bo, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, bf16* __restrict__ out, int N, int T, int c_in,
                    int heads, int D, int c_out, float scale, float eps, int residual, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int inner = heads * D;
  const int n0 = blockIdx.x * L.NB;
  bf16* xb = reinterpret_cast<bf16*>(smem + L.xb);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* wos = reinterpret_cast<bf16*>(smem + L.wo);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.qkv);
  bf16* oh = reinterpret_cast<bf16*>(smem + L.oh);
  float* sbuf = reinterpret_cast<float*>(smem + L.s);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.p);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* st = stage + warp * 256;

  // block row r holds token t = r % TP of sequence n0 + r / TP (zeros past N or T)
  for (int r = warp; r < L.R; r += WARPS) {
    const int seq = n0 + r / L.TP, t = r % L.TP;
    bf16* dst = xb + r * L.ldx;
    if (seq < N && t < T) {
      const bf16* src = x + ((long long)seq * T + t) * c_in;
      if (ln_s != nullptr) {
        warp_layernorm_row(src, dst, c_in, ln_s, ln_b, eps, lane);
      } else {
        for (int i = lane; i < c_in; i += 32) dst[i] = src[i];
      }
    } else {
      for (int i = lane; i < c_in; i += 32) dst[i] = __float2bfloat16(0.f);
    }
  }

  const int m_tiles = L.R / 16, n_tiles = c_out / 16, tt = L.TP / 16;
  ws::Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int h = 0; h < heads; ++h) {
    for (int half = 0; half < D / 32; ++half) {
      __syncthreads();  // the previous out-projection is done with wos and oh; xb is ready
      ws::load_cols32<WARPS>(wo, inner, c_out, h * D + half * 32, wos);
      if (half == 0) {
        // q|k|v of head h, 64 columns at a time (D % 64 == 0: a group lies in one matrix)
        for (int g = 0; g < 3 * D / 64; ++g) {
          const int part = g * 64 / D, row0 = h * D + g * 64 % D;
          const bf16* w = part == 0 ? wq : part == 1 ? wk : wv;
          ws::Acc q[G1F];
          ws::gemm_rows64<WARPS>(xb, L.ldx, m_tiles, c_in,
                                 [&](int r) { return w + (long long)(row0 + r) * c_in; }, ring, q);
#pragma unroll
          for (int f = 0; f < G1F; ++f) {
            const int t = warp + f * WARPS;
            if (t < m_tiles * 4) {
              store_bf16(q[f], st, qkv + (t / 4) * 16 * L.ldq + g * 64 + (t % 4) * 16, L.ldq, lane);
            }
          }
        }
        __syncthreads();
        // scores and softmax, one warp per sequence
        for (int s = warp; s < L.NB; s += WARPS) {
          const bf16* qs = qkv + s * L.TP * L.ldq;
          float* S = sbuf + s * L.TP * L.lds;
          for (int ti = 0; ti < tt; ++ti)
            for (int tj = 0; tj < tt; ++tj) {
              ws::Acc c;
              wmma::fill_fragment(c, 0.f);
              for (int kk = 0; kk < D / 16; ++kk) {
                ws::FragA a;
                ws::FragB b;
                wmma::load_matrix_sync(a, qs + ti * 16 * L.ldq + kk * 16, L.ldq);
                wmma::load_matrix_sync(b, qs + tj * 16 * L.ldq + D + kk * 16, L.ldq);
                wmma::mma_sync(c, a, b, c);
              }
              wmma::store_matrix_sync(S + ti * 16 * L.lds + tj * 16, c, L.lds, wmma::mem_row_major);
            }
          __syncwarp();
          if (lane < L.TP) {
            float* srow = S + lane * L.lds;
            float m = -1e30f;
            for (int j = 0; j < T; ++j) m = fmaxf(m, srow[j] * scale);
            float l = 0.f;
            for (int j = 0; j < T; ++j) {
              const float e = expf(srow[j] * scale - m);
              srow[j] = e;
              l += e;
            }
            bf16* prow = pbuf + (s * L.TP + lane) * L.ldp;
            for (int j = 0; j < L.TP; ++j) prow[j] = __float2bfloat16(j < T ? srow[j] / l : 0.f);
          }
        }
        __syncthreads();
        // o_h = P V, (sequence, row tile, d tile) spread over the warps
        for (int task = warp; task < L.NB * tt * (D / 16); task += WARPS) {
          const int s = task / (tt * (D / 16)), ti = task / (D / 16) % tt, dt = task % (D / 16);
          const bf16* vs = qkv + s * L.TP * L.ldq + 2 * D + dt * 16;
          const bf16* ps = pbuf + (s * L.TP + ti * 16) * L.ldp;
          ws::Acc c;
          wmma::fill_fragment(c, 0.f);
          for (int kk = 0; kk < tt; ++kk) {
            ws::FragA a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(a, ps + kk * 16, L.ldp);
            wmma::load_matrix_sync(b, vs + kk * 16 * L.ldq, L.ldq);
            wmma::mma_sync(c, a, b, c);
          }
          store_bf16(c, st, oh + (s * L.TP + ti * 16) * L.ldo + dt * 16, L.ldo, lane);
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // o_h and the Wo chunk are ready
      ws::mma_k32<WARPS>(oh + half * 32, L.ldo, m_tiles, n_tiles, wos, acc);
    }
  }

  __syncthreads();
  ws::store_rows<WARPS>(acc, stage, m_tiles, n_tiles, [&](int r) {
    const int seq = n0 + r / L.TP, t = r % L.TP;
    return seq < N && t < T ? (long long)seq * T + t : -1LL;
  }, bo, residual ? x : nullptr, c_in, out, c_out);
}

}  // namespace

// x (N, T, C_in) bf16; wq/wk/wv (heads*D, C_in) and wo (C_out, heads*D) bf16 in
// the torch Linear layout; bo (C_out) f32; ln_s/ln_b (C_in) f32 or null;
// out (N, T, C_out) bf16. T <= 32; C_in and D multiples of 64, C_out of 16;
// 16-byte aligned weights.
extern "C" int temporal_mha_fwd(const void* x, const void* wq, const void* wk, const void* wv,
                                const void* wo, const void* bo,
                                const void* ln_s, const void* ln_b, void* out, int N, int T, int c_in,
                                int heads, int D, int c_out, float scale, float eps, int residual,
                                void* stream) {
  if (T < 1 || T > 32 || c_in % ws::KS || c_out % 16 || D % 64) return (int)cudaErrorInvalidValue;
  const int TP = T <= 16 ? 16 : 32;
  // most rows whose output tiles fit 5 fragments per warp; at least one sequence (10 fragments)
  int R = TP;
  while (R < 128 && (2 * R / 16) * (c_out / 16) <= 5 * WARPS) R *= 2;
  const int tiles = (R / 16) * (c_out / 16);
  if (tiles > 10 * WARPS) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(R, TP, c_in, c_out, D);
  if (L.total > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int blocks = (N + L.NB - 1) / L.NB;
  if (tiles <= 5 * WARPS) {
    cudaFuncSetAttribute(temporal_mha_kernel<5>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    RETURN_IF_ERR();
    temporal_mha_kernel<5><<<blocks, THREADS, L.total, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv, (const bf16*)wo, (const float*)bo,
        (const float*)ln_s, (const float*)ln_b, (bf16*)out, N, T, c_in, heads, D, c_out, scale, eps, residual, L);
  } else {
    cudaFuncSetAttribute(temporal_mha_kernel<10>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    RETURN_IF_ERR();
    temporal_mha_kernel<10><<<blocks, THREADS, L.total, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)wq, (const bf16*)wk, (const bf16*)wv, (const bf16*)wo, (const float*)bo,
        (const float*)ln_s, (const float*)ln_b, (bf16*)out, N, T, c_in, heads, D, c_out, scale, eps, residual, L);
  }
  RETURN_IF_ERR();
  return 0;
}
