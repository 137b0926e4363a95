// The Hopper attention core of K2, K5, K6, K6p and K7: tile geometry and the
// mask policy of K2 and K5 (a bool mask shared by the heads); the sm_90a
// building blocks their kernels are made of are in sm90.cuh. The kernel
// bodies, templates on the mask policy, are in flash_hopper_kernels.cuh; the
// epipolar policies (K6 and K7's line mask, K6p's penalties) are in
// epipolar_mask.cuh.
//
// Tiles. Query tiles of BQ = 128 rows (the forward's block: two consumer
// warpgroups of 64 rows each) and key tiles of BK = 64 keys; the tile maps
// that skip empty tiles (`ops/flash_attention.py::_tiles`,
// `ops/epipolar_flash.py::kernel_tile_map`) are built on this grid. Every
// bf16 tile of (rows x D) lives in shared memory as DP / 64 "atoms" of
// (rows x 64) bf16, DP = D rounded up to 64, each atom 128-byte rows in the
// 128B swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)), which
// is what a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes and what a wgmma
// descriptor with layout type 1 reads. A tensor map over (D, H, L, B) with
// box (64, 1, rows, 1) fills one atom per copy and zero-fills the ragged row
// edge and the columns past D (D = 80 is read as two atoms, the second 16
// columns wide and 48 columns of zeros: the tensors are never padded).
//
// Products. `wgmma.mma_async` m64nNk16, bf16 inputs, f32 accumulators in
// registers. A from shared memory (K-major: Q, K, V, dO rows, D contiguous)
// or from registers (P and dS, converted from an accumulator: the m64nN
// accumulator of S is, 16 columns at a time, the register A fragment of the
// next product); B from shared memory, K-major for S = Q K^T, or MN-major
// (the transpose bit) for P V, dS K, P^T dO and dS^T Qs, where the product's
// K dimension runs over the tile's rows. Accumulator element d[4i + j] of
// thread t of the warpgroup (warp w = t / 32, lane l) sits at row
// 16 w + l / 4 + 8 (j / 2) and column 8 i + 2 (l % 4) + (j % 2), so a row's
// values are spread over the 4 threads of a quad and a row reduction is two
// xor-shuffles.
//
// The arithmetic is the JAX kernels' (and the plain twins'): q pre-scaled in
// bf16, bf16(q * bf16(scale)), before the product; f32 softmax; masked
// logits -1e30; the running max floored at -1e20 so masked logits give
// exactly 0; the row sum over the f32 probabilities and P rounded to bf16
// for the P V product only; keys at or past Lk masked (the zero-filled key
// rows would give a score of 0); a fully masked row gives 0 and lse +1e30.
// exp(x - m) is computed as exp2(x log2 e - m log2 e) with ex2.approx.
//
// The mask policy. A policy type has these members, called by the kernels:
//   static int stage_size(rows)   bytes of a ring slot's policy data for a
//                                 tile of `rows` query rows;
//   bool skip(b, qt, kt)          tile (query tile qt of BQ rows, key tile kt)
//                                 holds no visible pair: nothing is loaded;
//   void fill(slot, rows, lane, j0)  the producer warp's plain shared-memory
//                                 writes of the slot, every lane, before the
//                                 copies are issued;
//   uint32_t bytes(rows, j0)      the bytes stage() adds to the barrier;
//   void stage(slot, map, bar, rows, b, q0, j0)  the producer's
//                                 asynchronous copies of the policy's data
//                                 for one tile into the slot, on the stage's
//                                 barrier;
//   bool tested(j0, Lk)           key tile j0 has pairs whose bit must be
//                                 tested (else all its keys are visible);
//   bool visible(slot, r, c, j0, Lk)  the bit of row r (query) and key c of
//                                 the staged tile, on fragment coordinates;
//   void score(slot, r, c, j0, s0, s1)  the forward's logits of keys c and
//                                 c + 1 (c even) of row r of the tile at
//                                 key j0, raised in place from their scaled
//                                 products s0, s1 (visible pairs; `slot` is
//                                 the staged tile). Only the penalty policy
//                                 changes them; the backward sweeps serve
//                                 the policies that do not. The hook takes
//                                 the even key of a pair: for an odd
//                                 column 8 i + 2 (lane % 4) + 1, even after
//                                 `& ~1`, nvcc 12.8 dropped the `>> 3` of
//                                 `tile_offset`'s 16-byte chunk.
#pragma once

#include "sm90.cuh"

namespace hflash {

constexpr int BQ = 128;      // query rows of a tile (of the forward block, and of the tile map)
constexpr int BK = 64;       // keys of a tile
constexpr int STAGES = 2;    // depth of the shared-memory ring of streamed tiles
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LSE_MASKED = 1e30f;  // lse of a fully masked row: exp(s - lse) == 0
constexpr float LOG2E = 1.4426950408889634f;

// D rounded up to a whole number of 64-column atoms
__host__ __device__ constexpr int padded_d(int d) { return d <= 64 ? 64 : 128; }

using namespace sm90;  // the building blocks

// the `rows` x D tile at row `row0` of (B, L, H, D) head h, as DP / 64 atoms
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int rows, int row0,
                                         int h, int b) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) tma_load_4d(dst + a * rows * 128, map, bar, a * 64, h, row0, b);
}

// ---------------------------------------------------------------- the mask policy of K2 and K5

// An optional (B|1, nq*BQ, nk*BK) uint8 mask (the caller's (B|1, Lq, Lk)
// bool mask zero-padded to whole tiles, shared by the heads) with its
// (B, nq, nk) non-empty-tile map. The producer stages a (rows x BK) tile of
// it into shared memory by TMA; the consumers read their fragment's bits
// there. Keys at or past Lk are zero in the padded mask; without a mask
// they are tested on the ragged last tile only.
struct BoolMask {
  const uint8_t* tile_any;  // null: no tile is skipped
  int nq, nk;
  bool on;    // a mask is given
  bool shared;  // one mask for the whole batch

  static constexpr int stage_size(int rows) { return rows * BK; }
  __device__ bool skip(int b, int qt, int kt) const {
    return tile_any != nullptr && !tile_any[((long long)b * nq + qt) * nk + kt];
  }
  __device__ void fill(uint8_t*, int, int, int) const {}
  __device__ uint32_t bytes(int rows, int) const { return on ? rows * BK : 0; }
  __device__ void stage(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int, int b, int q0, int j0) const {
    if (on) tma_load_3d(dst, map, bar, j0, q0, shared ? 0 : b);
  }
  __device__ bool tested(int j0, int Lk) const { return on || j0 + BK > Lk; }
  __device__ bool visible(const uint8_t* tile, int r, int c, int j0, int Lk) const {
    return on ? tile[r * BK + c] != 0 : j0 + c < Lk;
  }
  __device__ void score(const uint8_t*, int, int, int, float&, float&) const {}
};

// ---------------------------------------------------------------- tensor maps (host)

// (B, L, H, D) bf16, box (64, 1, rows, 1), 128B swizzle; false on failure
inline bool bf16_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the padded (Bm, rows_total, cols) uint8 mask, box (BK, rows, 1)
inline bool mask_map(CUtensorMap* map, const void* ptr, int Bm, int rows_total, int cols, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows_total, (cuuint64_t)Bm};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)rows_total * cols};
  const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hflash
