// The attention core of K6, K6p and K7 (epipolar flash attention, the mask
// recomputed from epipolar lines or read as penalties): the online-softmax
// forward and the two backward sweeps (dq; dk and dv). K2 and K5 (flash
// attention with a bool mask, its policy `BoolMask`) moved to the Hopper
// core, flash_hopper.cuh, which keeps these four policy members and calls
// them on wgmma fragment coordinates.
//
// Blocks of 4 warps; Q/K/V/dO tiles of 64 rows staged in shared memory with
// 16-byte loads; WMMA 16x16x16 bf16 MMAs with f32 accumulators; each warp's
// 16x64 score tile, its bf16 probability tile and its f32 accumulators live
// in shared memory, where one lane pair per row runs the elementwise math.
// Same arithmetic as the JAX kernels: q is pre-scaled in bf16, masked logits
// are -1e30, the running max is floored at -1e20 so masked logits give
// exactly 0, keys at or past `lk_valid` are masked, and fully masked rows give
// 0 with lse = +1e30. The backward is the standard two-sweep flash backward
// over qs = bf16(q * scale), which the caller forms as the JAX backward does:
// p = exp(s - lse), ds = p * (dp - delta), delta = rowsum(dout * out) in f32;
// dq = scale * (ds K) rounded as bf16(bf16(ds K) * scale), dk = ds^T qs,
// dv = p^T dout, with ds and p cast to bf16 for the products and every sum
// in f32. Skipped tiles hold no visible pair, so p = ds = 0 there and the
// skip is exact in the backward too. A warp's bf16 p and ds tiles overwrite
// its f32 s and dp tiles (each lane reads its 32 values into registers
// first), which keeps the dk/dv sweep at two blocks per SM for D = 64.
//
// The mask is a policy type with three members, called by every thread:
//   bool skip(b, qt, kt)            the 64x64 tile (query tile qt, key tile
//                                   kt) is empty (nothing loaded);
//   void stage(b, q0, j0)           per-tile block-wide preparation, between
//                                   the two barriers that bracket the loads;
//   bool visible(b, r, qrow, kj)    the bit of query qrow (row r of the query
//                                   tile) and key kj;
// and, for the forward, a fourth:
//   float score(r, kj, s)           the logit of a visible pair from its
//                                   scaled product s (s itself, or s plus an
//                                   additive penalty).
#pragma once

#include "common.cuh"

namespace flash {

using namespace nvcuda;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int WARPS = 4;
constexpr int LDS = BK + 4;  // f32 score tile
constexpr int LDP = BK + 8;  // bf16 probability tile
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LSE_MASKED = 1e30f;  // lse of a fully masked row: exp(s - lse) == 0

// shared memory of the forward core; a mask policy's own staging area follows it
__host__ __device__ inline size_t core_smem_bytes(int d) {
  const int ldq = d + 8, lda = d + 4;
  return (size_t)3 * BQ * ldq * 2 + (size_t)WARPS * 16 * LDS * 4 + (size_t)WARPS * 16 * LDP * 2 +
         (size_t)WARPS * 16 * lda * 4;
}

// shared memory of the backward sweeps: four 64-row tiles, the warps' S and
// dP tiles (their bf16 P and dS tiles alias them), `accs` f32 accumulators
// per warp, and the 64 rows' lse and delta
__host__ __device__ inline size_t bwd_smem_bytes(int d, int accs) {
  const int ldq = d + 8, lda = d + 4;
  return (size_t)4 * BQ * ldq * 2 + (size_t)2 * WARPS * 16 * LDS * 4 + (size_t)accs * WARPS * 16 * lda * 4 +
         (size_t)2 * BQ * 4;
}

// rows [row0, row0 + BK) of (B, len, H, D) at head h, zero past `valid`
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, bf16* dst, int row0, int valid,
                                          long long len, int b, int h, int H, int D, int ld) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < BK * chunks; i += blockDim.x) {
    const int r = i / chunks, c8 = i % chunks;
    const int row = row0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) v = *reinterpret_cast<const uint4*>(src + (((long long)b * len + row) * H + h) * D + c8 * 8);
    *reinterpret_cast<uint4*>(dst + r * ld + c8 * 8) = v;
  }
}

// the query tile at q0, pre-scaled in bf16 (the TPU kernels fold the scale
// into q: bf16(q * scale)), zero past Lq
__device__ __forceinline__ void load_q_scaled(const bf16* __restrict__ q, bf16* dst, int q0, int Lq, int b, int h,
                                              int H, int D, int ld, float scale) {
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    float val = 0.f;
    if (row < Lq) val = __bfloat162float(q[(((long long)b * Lq + row) * H + h) * D + d]) * scale;
    dst[r * ld + d] = __float2bfloat16(val);
  }
}

// C (16 x 64, f32, ld LDS) = A (16 x D rows of `a`, ld) . B^T, B the 64 rows of `bt` (ld)
__device__ __forceinline__ void mma_abt(const bf16* a, const bf16* bt, int ld, int D, float* c_out) {
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk * 16, ld);
      wmma::load_matrix_sync(fb, bt + n * 16 * ld + kk * 16, ld);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(c_out + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// acc (16 x D, f32, ld lda) += P (16 x 64 bf16, ld LDP) . B (64 rows of `b`, ld)
__device__ __forceinline__ void mma_pb_acc(const bf16* p, const bf16* b, int ld, int D, float* acc, int lda) {
  for (int dt = 0; dt < D / 16; ++dt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::load_matrix_sync(c, acc + dt * 16, lda, wmma::mem_row_major);
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + kk * 16, LDP);
      wmma::load_matrix_sync(fb, b + kk * 16 * ld + dt * 16, ld);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + dt * 16, c, lda, wmma::mem_row_major);
  }
}

// Forward of the block that owns query tile qt of head h in batch b.
// q (B, Lq, H, D); k/v (B, Lk, H, D) of which the first lk_valid keys exist.
// lse (B, H, Lq) f32 is written when not null (m + log l, or +1e30 for a
// fully masked row).
template <class Mask>
__device__ __forceinline__ void attention_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, bf16* __restrict__ out,
                                               float* __restrict__ lse, int Lq, int Lk, int lk_valid, int H,
                                               int D, float scale, int nk, unsigned char* smem, Mask& mask,
                                               int qt, int h, int b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldq = D + 8, lda = D + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * ldq;
  bf16* Vs = Ks + BK * ldq;
  float* S0 = reinterpret_cast<float*>(Vs + BK * ldq);
  bf16* P0 = reinterpret_cast<bf16*>(S0 + WARPS * 16 * LDS);
  float* A0 = reinterpret_cast<float*>(P0 + WARPS * 16 * LDP);
  float* Sw = S0 + warp * 16 * LDS;
  bf16* Pw = P0 + warp * 16 * LDP;
  float* Aw = A0 + warp * 16 * lda;

  const int q0 = qt * BQ;
  load_q_scaled(q, Qs, q0, Lq, b, h, H, D, ldq, scale);
  for (int i = lane; i < 16 * lda; i += 32) Aw[i] = 0.f;

  const int r = lane >> 1, half = lane & 1;
  const int rb = warp * 16 + r;  // row within the block's tile
  const int qrow = q0 + rb;
  float m_i = M_FLOOR, l_i = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (mask.skip(b, qt, kt)) continue;
    const int j0 = kt * BK;
    __syncthreads();
    load_tile(k, Ks, j0, lk_valid, Lk, b, h, H, D, ldq);
    load_tile(v, Vs, j0, lk_valid, Lk, b, h, H, D, ldq);
    mask.stage(b, q0, j0);
    __syncthreads();

    mma_abt(Qs + warp * 16 * ldq, Ks, ldq, D, Sw);  // S = Q_w K^T (16 x 64)
    __syncwarp();

    // online softmax: lanes 2r, 2r+1 own query row r, 32 keys each
    float vals[32];
    float mx = NEG_INF;
    const float* srow = Sw + r * LDS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = j0 + half * 32 + j;
      const bool ok = kj < lk_valid && qrow < Lq && mask.visible(b, rb, qrow, kj);
      const float s = ok ? mask.score(rb, kj, srow[j]) : NEG_INF;
      vals[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(fmaxf(m_i, mx), M_FLOOR);
    float sum = 0.f;
    bf16* prow = Pw + r * LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = expf(vals[j] - m_new);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_i - m_new);
    l_i = alpha * l_i + sum;
    m_i = m_new;
    float* arow = Aw + r * lda;
    for (int d = half; d < D; d += 2) arow[d] *= alpha;
    __syncwarp();

    mma_pb_acc(Pw, Vs, ldq, D, Aw, lda);  // acc += P V (16 x D)
    __syncwarp();
  }

  __syncwarp();
  if (qrow < Lq) {
    const float safe_l = l_i == 0.f ? 1.f : l_i;
    const float* arow = Aw + r * lda;
    bf16* orow = out + (((long long)b * Lq + qrow) * H + h) * D;
    for (int d = half; d < D; d += 2) orow[d] = __float2bfloat16(arow[d] / safe_l);
    if (lse != nullptr && half == 0)
      lse[((long long)b * H + h) * Lq + qrow] = l_i == 0.f ? LSE_MASKED : m_i + logf(l_i);
  }
}

// Backward, dq sweep: one block per (64-query tile, head, batch), looping
// over the key tiles. qs, dout (B, Lq, H, D) bf16; lse, delta (B, H, Lq)
// f32; dq (B, Lq, H, D) bf16.
template <class Mask>
__device__ __forceinline__ void bwd_dq_body(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                            const float* __restrict__ lse, const float* __restrict__ delta,
                                            bf16* __restrict__ dq, int Lq, int Lk, int lk_valid, int H, int D,
                                            float scale, int nk, unsigned char* smem, Mask& mask) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldq = D + 8, lda = D + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * ldq;
  bf16* Ks = dOs + BQ * ldq;
  bf16* Vs = Ks + BK * ldq;
  float* S0 = reinterpret_cast<float*>(Vs + BK * ldq);
  float* dP0 = S0 + WARPS * 16 * LDS;
  float* A0 = dP0 + WARPS * 16 * LDS;
  float* Sw = S0 + warp * 16 * LDS;
  float* dPw = dP0 + warp * 16 * LDS;
  bf16* dSw = reinterpret_cast<bf16*>(dPw);  // dS overwrites dP
  float* Aw = A0 + warp * 16 * lda;

  const int q0 = qt * BQ;
  load_tile(qs, Qs, q0, Lq, Lq, b, h, H, D, ldq);
  load_tile(dout, dOs, q0, Lq, Lq, b, h, H, D, ldq);
  for (int i = lane; i < 16 * lda; i += 32) Aw[i] = 0.f;

  const int r = lane >> 1, half = lane & 1;
  const int rb = warp * 16 + r;
  const int qrow = q0 + rb;
  const long long srow_idx = ((long long)b * H + h) * Lq + qrow;
  const float row_lse = qrow < Lq ? lse[srow_idx] : LSE_MASKED;
  const float row_delta = qrow < Lq ? delta[srow_idx] : 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    if (mask.skip(b, qt, kt)) continue;
    const int j0 = kt * BK;
    __syncthreads();
    load_tile(k, Ks, j0, lk_valid, Lk, b, h, H, D, ldq);
    load_tile(v, Vs, j0, lk_valid, Lk, b, h, H, D, ldq);
    mask.stage(b, q0, j0);
    __syncthreads();

    mma_abt(Qs + warp * 16 * ldq, Ks, ldq, D, Sw);    // S = Qs_w K^T
    mma_abt(dOs + warp * 16 * ldq, Vs, ldq, D, dPw);  // dP = dO_w V^T
    __syncwarp();
    const float* srow = Sw + r * LDS + half * 32;
    const float* dprow = dPw + r * LDS + half * 32;
    float ds[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = j0 + half * 32 + j;
      const bool ok = kj < lk_valid && qrow < Lq && mask.visible(b, rb, qrow, kj);
      const float p = ok ? expf(srow[j] - row_lse) : 0.f;
      ds[j] = p * (dprow[j] - row_delta);
    }
    __syncwarp();
    bf16* dsrow = dSw + r * LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) dsrow[j] = __float2bfloat16(ds[j]);
    __syncwarp();
    mma_pb_acc(dSw, Ks, ldq, D, Aw, lda);  // acc += dS K
    __syncwarp();
  }

  __syncwarp();
  if (qrow < Lq) {
    const float* arow = Aw + r * lda;
    bf16* orow = dq + (((long long)b * Lq + qrow) * H + h) * D;
    for (int d = half; d < D; d += 2)
      orow[d] = __float2bfloat16(__bfloat162float(__float2bfloat16(arow[d])) * scale);
  }
}

// Backward, dk/dv sweep: one block per (64-key tile, head, batch), looping
// over the query tiles; warp w owns keys [16w, 16w + 16) of the tile.
// dk, dv (B, Lk, H, D) bf16, rows at or past lk_valid left unwritten.
template <class Mask>
__device__ __forceinline__ void bwd_dkv_body(const bf16* __restrict__ qs, const bf16* __restrict__ k,
                                             const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                             const float* __restrict__ lse, const float* __restrict__ delta,
                                             bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq, int Lk,
                                             int lk_valid, int H, int D, int nq, unsigned char* smem, Mask& mask) {
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldq = D + 8, lda = D + 4;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * ldq;
  bf16* Qs = Vs + BK * ldq;
  bf16* dOs = Qs + BQ * ldq;
  float* S0 = reinterpret_cast<float*>(dOs + BQ * ldq);
  float* dP0 = S0 + WARPS * 16 * LDS;
  float* dK0 = dP0 + WARPS * 16 * LDS;
  float* dV0 = dK0 + WARPS * 16 * lda;
  float* lse_s = dV0 + WARPS * 16 * lda;
  float* delta_s = lse_s + BQ;
  float* STw = S0 + warp * 16 * LDS;   // S^T: this warp's 16 keys x 64 queries
  float* dPTw = dP0 + warp * 16 * LDS;
  bf16* PTw = reinterpret_cast<bf16*>(STw);    // P^T overwrites S^T
  bf16* dSTw = reinterpret_cast<bf16*>(dPTw);  // dS^T overwrites dP^T
  float* dKw = dK0 + warp * 16 * lda;
  float* dVw = dV0 + warp * 16 * lda;

  const int j0 = kt * BK;
  load_tile(k, Ks, j0, lk_valid, Lk, b, h, H, D, ldq);
  load_tile(v, Vs, j0, lk_valid, Lk, b, h, H, D, ldq);
  for (int i = lane; i < 16 * lda; i += 32) dKw[i] = dVw[i] = 0.f;

  const int r = lane >> 1, half = lane & 1;
  const int kj = j0 + warp * 16 + r;  // this lane pair's key

  for (int qt = 0; qt < nq; ++qt) {
    if (mask.skip(b, qt, kt)) continue;
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile(qs, Qs, q0, Lq, Lq, b, h, H, D, ldq);
    load_tile(dout, dOs, q0, Lq, Lq, b, h, H, D, ldq);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      const int row = q0 + i;
      const long long idx = ((long long)b * H + h) * Lq + row;
      lse_s[i] = row < Lq ? lse[idx] : LSE_MASKED;
      delta_s[i] = row < Lq ? delta[idx] : 0.f;
    }
    mask.stage(b, q0, j0);
    __syncthreads();

    mma_abt(Ks + warp * 16 * ldq, Qs, ldq, D, STw);    // S^T = K_w Qs^T
    mma_abt(Vs + warp * 16 * ldq, dOs, ldq, D, dPTw);  // dP^T = V_w dO^T
    __syncwarp();
    const float* srow = STw + r * LDS + half * 32;
    const float* dprow = dPTw + r * LDS + half * 32;
    float p[32], ds[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qj = half * 32 + j;
      const int qrow = q0 + qj;
      const bool ok = kj < lk_valid && qrow < Lq && mask.visible(b, qj, qrow, kj);
      p[j] = ok ? expf(srow[j] - lse_s[qj]) : 0.f;
      ds[j] = p[j] * (dprow[j] - delta_s[qj]);
    }
    __syncwarp();
    bf16* prow = PTw + r * LDP + half * 32;
    bf16* dsrow = dSTw + r * LDP + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      prow[j] = __float2bfloat16(p[j]);
      dsrow[j] = __float2bfloat16(ds[j]);
    }
    __syncwarp();
    mma_pb_acc(PTw, dOs, ldq, D, dVw, lda);  // dV_w += P^T dO
    mma_pb_acc(dSTw, Qs, ldq, D, dKw, lda);  // dK_w += dS^T Qs
    __syncwarp();
  }

  __syncwarp();
  if (kj < lk_valid) {
    const long long o = (((long long)b * Lk + kj) * H + h) * D;
    for (int d = half; d < D; d += 2) {
      dk[o + d] = __float2bfloat16(dKw[r * lda + d]);
      dv[o + d] = __float2bfloat16(dVw[r * lda + d]);
    }
  }
}

}  // namespace flash
