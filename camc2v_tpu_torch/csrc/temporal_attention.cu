// K3: fused short-sequence (temporal) multi-head self-attention.
//
// Replaces the Pallas kernel camc2v_tpu/ops/temporal_attention.py::_kernel
// (entry fused_temporal_mha). For each of N sequences of T tokens:
//   [optional f32 LayerNorm]  xb = bf16(LN(x)) or x
//   qkv = bf16(xb @ [Wq|Wk|Wv])                  (f32 accumulation)
//   p_h = bf16(softmax(q_h k_h^T * scale))       (f32 scores and softmax)
//   o_h = bf16(p_h v_h)
//   out = bf16(o @ Wo^T + bo [+ f32(x)])
//
// Bound on the H100 by operations: 8 rows C^2 for the four projections plus
// 4 rows T C for the scores and P V (rows = N T), 0.0278 ms at the ds1 site
// (2048 x 16 tokens, C = 320). The projections are ~95% of it, so K3 is
// GEMMs on the core of gemm_hopper.cuh, one ctypes entry, up to three
// launches on the caller's stream:
//   1. with ln_s: ln::ln_rows (layernorm.cuh), bf16 LN(x) to scratch;
//   2. QKV and attention in one GEMM: a block's tile is (128 rows, head h);
//      its N tile is head h's [q_h | k_h | v_h], 192 weight rows in three TMA
//      boxes, so each consumer warpgroup holds a 64 x 192 accumulator. The
//      QkvAttention epilogue writes q, k and v as bf16 swizzled atoms into
//      shared memory; each warpgroup's 64 rows are 64 / T whole sequences
//      (T divides 64: the TPU kernel's block-diagonal packing, now on a
//      wgmma tile), so it computes its 64 x 64 scores with wgmma, masks keys
//      of other sequences, takes the softmax in registers (quad shuffles),
//      runs P V as an rs wgmma with P in registers, as the flash core does,
//      and writes o_h bf16 into the (rows, inner) scratch; qkv never leaves
//      the chip. Rows past N T are zeros (TMA fill), are their own sequences
//      and are not stored;
//   3. the out-projection on the same core with the BiasResidual epilogue
//      (K split where its tiles fill less than half the card).
// Every model site has T = 16 and D = 64; the kernels take T | 64 (T <= 32)
// and D = 64, and the wrapper raises on anything else.
#include "gemm_hopper.cuh"
#include "layernorm.cuh"

#ifndef QKV_STAGES
#define QKV_STAGES 4
#endif

namespace {

using namespace hgemm;

constexpr int D = 64;  // head dim
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct QkvAttention {
  static constexpr int BN = 3 * D;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGES = QKV_STAGES;
  static constexpr int ATOM = 64 * 128;   // a 64 x 64 bf16 tile
  static constexpr int SCRATCH = 4 * ATOM;  // q, k, v and o of the warpgroup's 64 rows
  bf16* o;  // (rows, inner)
  int rows, inner, log2t;
  float scale;

  __device__ void load_b(unsigned char* dst, const Maps& m, uint64_t* bar, int h, int k0) const {
#pragma unroll
    for (int p = 0; p < 3; ++p) tma_load_2d(dst + p * D * 128, &m.b[p], bar, k0, h * D);
  }

  __device__ void apply(float (&acc)[BN / 2], unsigned char* scratch, long long row0, int h, int, int wg) const {
    const int t = threadIdx.x % 128, r0 = acc_row(t), c0 = acc_col(t);
    unsigned char* Qs = scratch;
    unsigned char* Ks = scratch + ATOM;
    unsigned char* Vs = scratch + 2 * ATOM;
    unsigned char* Os = scratch + 3 * ATOM;
    named_barrier(1 + wg, 128);  // the previous tile's products and stores are done with the scratch
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + c0;
      unsigned char* dst = scratch + (c / D) * ATOM;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dst + tile_offset(64, r0 + 8 * hh, c % D)) =
            pack_bf16(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);

    // S = q k^T over the warpgroup's 64 rows (64 x 64)
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<0>(sc, desc_k(Qs, 64, 0, kk), desc_k(Ks, 64, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // keys of other sequences masked; f32 softmax per row, P = bf16(e * (1 / sum))
    const int seq0 = r0 >> log2t, seq1 = (r0 + 8) >> log2t;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = (8 * i + c0 + (j & 1)) >> log2t;
        const bool vis = key == (j < 2 ? seq0 : seq1);
        const float v = vis ? sc[4 * i + j] * scale : NEG_INF;
        sc[4 * i + j] = v;
        if (j < 2) mx0 = fmaxf(mx0, v);
        else mx1 = fmaxf(mx1, v);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] = ex2((sc[4 * i + 0] - mx0) * LOG2E);
      sc[4 * i + 1] = ex2((sc[4 * i + 1] - mx0) * LOG2E);
      sc[4 * i + 2] = ex2((sc[4 * i + 2] - mx1) * LOG2E);
      sc[4 * i + 3] = ex2((sc[4 * i + 3] - mx1) * LOG2E);
      l0 += sc[4 * i + 0] + sc[4 * i + 1];
      l1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] *= inv0;
      sc[4 * i + 1] *= inv0;
      sc[4 * i + 2] *= inv1;
      sc[4 * i + 3] *= inv1;
    }

    // o = P V, P as the register A operand, V MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragment(sc, kk, pa[kk]);
    float ov[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(ov, pa[kk], desc_mn(Vs, 64, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ov);

#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(Os + tile_offset(64, r0 + 8 * hh, 8 * i + c0)) =
            pack_bf16(ov[4 * i + 2 * hh], ov[4 * i + 2 * hh + 1]);
    }
    named_barrier(1 + wg, 128);
    store_tile<D>(Os, o, row0, h * D, rows, inner, inner, t);
  }
};

}  // namespace

// x (N, T, C_in) bf16; wq/wk/wv (heads*D, C_in) and wo (C_out, heads*D) bf16
// in the torch Linear layout; bo (C_out) f32; ln_s/ln_b (C_in) f32 or null;
// out (N, T, C_out) bf16; scratch xn (N T, C_in) (used with ln_s),
// o (N T, heads*D) bf16 and with splits > 1 ws (splits, N T, C_out) f32;
// splits: the out-projection's split of K (1, 2, 4 or 8). Every pointer
// 16-byte aligned; T | 64 and T <= 32, D == 64, C_in % 64 == 0,
// C_out % 8 == 0; residual needs C_out == C_in.
extern "C" int temporal_mha_fwd(const void* x, const void* wq, const void* wk, const void* wv, const void* wo,
                                const void* bo, const void* ln_s, const void* ln_b, void* out, void* xn, void* o,
                                void* ws, int N, int T, int c_in, int heads, int d, int c_out, int splits, float scale,
                                float eps, int residual, void* stream) {
  if (T < 1 || T > 32 || 64 % T || d != D || c_in % BK || c_out % 8 || N <= 0 || heads <= 0 ||
      (residual && c_out != c_in))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = N * T, inner = heads * D;
  const void* a = x;
  if (ln_s != nullptr) {
    const int err = ln::launch<bf16>((const bf16*)x, (const float*)ln_s, (const float*)ln_b, (bf16*)xn, rows, c_in,
                                     eps, st);
    if (err) return err;
    a = xn;
  }
  Maps m{};
  if (!bf16_map_2d(&m.a, a, rows, c_in, BM) || !bf16_map_2d(&m.b[0], wq, inner, c_in, D) ||
      !bf16_map_2d(&m.b[1], wk, inner, c_in, D) || !bf16_map_2d(&m.b[2], wv, inner, c_in, D))
    return (int)cudaErrorInvalidValue;
  int log2t = 0;
  while ((1 << log2t) < T) ++log2t;
  const int err = launch(m, QkvAttention{(bf16*)o, rows, inner, log2t, scale}, rows, c_in, heads, st);
  if (err) return err;
  return bias_residual(o, wo, (const float*)bo, residual ? (const bf16*)x : nullptr, (bf16*)out, rows, inner, c_out,
                       splits, (float*)ws, st);
}
