// Block-level GEMM pieces shared by K3 (temporal MHA) and K4 (LN + GEGLU FF).
//
// Both kernels hold a block's normalised input rows in shared memory and
// stream weight matrices (torch Linear layout, (out, in), L2-resident because
// every block reads the same weights) through shared memory with cp.async:
//   gemm_rows64   (M, 64) = A (M, K) @ W[64 rows]^T, the 64 weight rows
//                 chosen by the caller, K in double-buffered slices of 64;
//   load_cols32 + mma_k32   acc (M, N) += A (M, 32) @ B (N, 32)^T, with the
//                 (N, 32) column chunk of a weight staged whole;
//   store_rows    acc + bias [+ f32 residual] -> bf16 rows of the output.
// Accumulator tile t of an (m_tiles, n_tiles) grid belongs to warp
// t % WARPS, as fragment t / WARPS. WMMA 16x16x16 bf16, f32 accumulation.
#pragma once

#include "common.cuh"

namespace ws {

using namespace nvcuda;

constexpr int KS = 64;       // k-slice of gemm_rows64
constexpr int LDW = KS + 8;  // row of a staged slice (bf16), padded against bank conflicts
constexpr int LDC = 32 + 8;  // row of a staged 32-column chunk (bf16)

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;

// bytes of the slice ring gemm_rows64 needs
__host__ __device__ constexpr size_t ring_bytes() { return (size_t)2 * 64 * LDW * 2; }
// bytes of a staged (n, 32) chunk
__host__ __device__ constexpr size_t chunk_bytes(int n) { return (size_t)n * LDC * 2; }

// acc (m_tiles*16, 64) = A @ W^T over K (K % 64 == 0), where row(r) points at
// weight row r = 0..63 (K contiguous bf16, 16-byte aligned). Every cp.async
// group committed before the call has also landed when it returns, and the
// ring is free again.
template <int WARPS, int NF, typename RowPtr>
__device__ __forceinline__ void gemm_rows64(const bf16* A, int lda, int m_tiles, int K, RowPtr row,
                                            bf16* ring, Acc (&acc)[NF]) {
  const int warp = threadIdx.x / 32;
  auto load = [&](int ks) {
    bf16* dst = ring + (ks & 1) * 64 * LDW;
    for (int i = threadIdx.x; i < 64 * (KS / 8); i += WARPS * 32) {
      const int r = i / (KS / 8), c8 = i % (KS / 8);
      cp_async16(dst + r * LDW + c8 * 8, row(r) + ks * KS + c8 * 8);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int nks = K / KS;
  load(0);
  for (int ks = 0; ks < nks; ++ks) {
    if (ks + 1 < nks) {
      load(ks + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* w = ring + (ks & 1) * 64 * LDW;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const int t = warp + f * WARPS;
      if (t < m_tiles * 4) {
        const int i = t / 4, j = t % 4;
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk) {
          FragA a;
          FragB b;
          wmma::load_matrix_sync(a, A + i * 16 * lda + ks * KS + kk * 16, lda);
          wmma::load_matrix_sync(b, w + j * 16 * LDW + kk * 16, LDW);
          wmma::mma_sync(acc[f], a, b, acc[f]);
        }
      }
    }
    __syncthreads();  // this slice's buffer is reloaded two slices on
  }
}

// stage columns [col0, col0 + 32) of the n rows of w (row stride ldw) into
// dst (n, LDC); commits one cp.async group
template <int WARPS>
__device__ __forceinline__ void load_cols32(const bf16* __restrict__ w, long long ldw, int n, int col0,
                                            bf16* dst) {
  for (int i = threadIdx.x; i < n * 4; i += WARPS * 32) {
    const int r = i / 4, c8 = i % 4;
    cp_async16(dst + r * LDC + c8 * 8, w + r * ldw + col0 + c8 * 8);
  }
  cp_async_commit();
}

// acc (m_tiles*16, n_tiles*16) += A (., 32) @ B^T with B the staged (n, 32) chunk
template <int WARPS, int NF>
__device__ __forceinline__ void mma_k32(const bf16* A, int lda, int m_tiles, int n_tiles, const bf16* B,
                                        Acc (&acc)[NF]) {
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int t = warp + f * WARPS;
    if (t < m_tiles * n_tiles) {
      const int i = t / n_tiles, j = t % n_tiles;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, A + i * 16 * lda + kk * 16, lda);
        wmma::load_matrix_sync(b, B + j * 16 * LDC + kk * 16, LDC);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
  }
}

// out[grow(r) * n + col] = bf16(acc + bias[col] (+ resid[grow(r) * ld_resid + col]))
// for the block's rows r with grow(r) >= 0. stage: 256 f32 per warp.
template <int WARPS, int NF, typename GlobalRow>
__device__ __forceinline__ void store_rows(Acc (&acc)[NF], float* stage, int m_tiles, int n_tiles,
                                           GlobalRow grow, const float* __restrict__ bias,
                                           const bf16* __restrict__ resid, int ld_resid,
                                           bf16* __restrict__ out, int n) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const int t = warp + f * WARPS;
    if (t < m_tiles * n_tiles) {
      const int i = t / n_tiles, j = t % n_tiles;
      wmma::store_matrix_sync(st, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long g = grow(i * 16 + e / 16);
        const int col = j * 16 + e % 16;
        if (g >= 0) {
          float v = st[e] + bias[col];
          if (resid != nullptr) v += __bfloat162float(resid[g * ld_resid + col]);
          out[g * n + col] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace ws
