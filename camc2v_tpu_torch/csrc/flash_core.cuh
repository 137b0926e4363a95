// Online-softmax attention core shared by K2 (flash attention, bool mask) and
// K6 (epipolar flash attention, mask recomputed from epipolar lines).
//
// One block of 4 warps per (64-query tile, head, batch); K/V tiles of 64 keys
// staged in shared memory with 16-byte loads; WMMA 16x16x16 bf16 MMAs with f32
// accumulators; the 16x64 score tile, the bf16 P tile and the f32 output
// accumulator of each warp live in shared memory, where one lane pair per
// query row runs the online softmax. Same arithmetic as the JAX kernels: q is
// pre-scaled in bf16, masked logits are -1e30, the running max is floored at
// -1e20 so masked logits give exactly 0, keys at or past `lk_valid` are
// masked, and fully masked rows give 0.
//
// The mask is a policy type with three members, called by every thread:
//   bool skip(b, qt, kt)            the whole key tile is empty (not loaded);
//   void stage(b, q0, j0)           per-tile block-wide preparation, between
//                                   the two barriers that bracket the K/V load;
//   bool visible(b, r, qrow, kj)    the bit of query qrow (row r of the tile)
//                                   and key kj.
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

// shared memory of the core; a mask policy's own staging area follows it
__host__ __device__ inline size_t core_smem_bytes(int d) {
  const int ldq = d + 8, lda = d + 4;
  return (size_t)3 * BQ * ldq * 2 + (size_t)WARPS * 16 * LDS * 4 + (size_t)WARPS * 16 * LDP * 2 +
         (size_t)WARPS * 16 * lda * 4;
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

// q (B, Lq, H, D); k/v (B, Lk, H, D) of which the first lk_valid keys exist.
template <class Mask>
__device__ __forceinline__ void attention_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, bf16* __restrict__ out, int Lq,
                                               int Lk, int lk_valid, int H, int D, float scale, int nk,
                                               unsigned char* smem, Mask& mask) {
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
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
  // Q tile, pre-scaled in bf16 (the TPU kernels fold the scale into q)
  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    float val = 0.f;
    if (row < Lq) val = __bfloat162float(q[(((long long)b * Lq + row) * H + h) * D + d]) * scale;
    Qs[r * ldq + d] = __float2bfloat16(val);
  }
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

    // S = Q_w K^T (16 x 64)
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * ldq + kk * 16, ldq);
        wmma::load_matrix_sync(bt, Ks + n * 16 * ldq + kk * 16, ldq);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(Sw + n * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: lanes 2r, 2r+1 own query row r, 32 keys each
    float vals[32];
    float mx = NEG_INF;
    const float* srow = Sw + r * LDS + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kj = j0 + half * 32 + j;
      const bool ok = kj < lk_valid && qrow < Lq && mask.visible(b, rb, qrow, kj);
      const float s = ok ? srow[j] : NEG_INF;
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

    // acc += P V (16 x D)
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, Aw + dt * 16, lda, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Pw + kk * 16, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * 16 * ldq + dt * 16, ldq);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(Aw + dt * 16, c, lda, wmma::mem_row_major);
    }
    __syncwarp();
  }

  __syncwarp();
  if (qrow < Lq) {
    const float safe_l = l_i == 0.f ? 1.f : l_i;
    const float* arow = Aw + r * lda;
    bf16* orow = out + (((long long)b * Lq + qrow) * H + h) * D;
    for (int d = half; d < D; d += 2) orow[d] = __float2bfloat16(arow[d] / safe_l);
  }
}

}  // namespace flash
