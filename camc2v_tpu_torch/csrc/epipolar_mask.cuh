// The epipolar mask policies of the Hopper core (flash_hopper.cuh): the line
// mask of K6 (forward) and K7 (backward), one copy of the distance formula
// for both, so the backward recomputes the forward's bits; and the
// precomputed penalties of K6p (forward only), at the end of this file.
//
// Key j < t*hw of frame f = j / hw is visible to query i when
// |a*px + b*py + c| < ds*sqrt(2)/2, (a, b, c) = lines[b, i, f] (f32) and
// (px, py) the image coordinates of pixel j % hw, x * ds + ds / 2 - 0.5 in
// f32, left to right; the distance is formed as
// __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c), the order the
// plain twin uses in eager torch, so no FMA contraction flips a borderline
// bit; NaN lines (F == 0) compare false and hide their whole frame. The
// `nreg` keys after the frames (register tokens) are always visible, and
// keys at or past Lk = t*hw + nreg are masked.
//
// Where the geometry lives: in the ring slot beside K and V, so the
// consumers' registers hold none of it. A slot holds the tile's 64 key
// coordinates (x, y), written by the producer warp's lanes (`fill`, two keys
// a lane), then the `rows` query rows' lines (a, b, c) of the tile's frame,
// one bulk copy from the (B, t, Lq, 3) lines (`stage`; a 64-key tile never
// spans two frames, since hw % 64 == 0). The register tile stages lines of 0
// and coordinates (0, 0) for its nreg keys and NaN past them, so one formula
// gives every bit: distance 0 (visible) or NaN (masked). Every pair of a
// tile is tested (`tested` is always true).
//
// Skipping: `tile_any` (B, Lq / BQ, cols) int32 is the hull map at the
// kernels' own tiling (`ops/epipolar_flash.py::kernel_tile_map`: 128-query
// rows, 64-key subtiles, the register column at t*hw / 64), read directly
// as the core's (query tile, key tile) map; the sweeps' 64-query tiles read
// their 128-query row.
#pragma once

#include "flash_hopper.cuh"

namespace hflash {

struct LineMask {
  const int* tile_any;  // (B, nq, cols)
  const float* lines;   // (B, t, Lq, 3)
  int nq, cols, Lq, t, thw, hw, w, nreg;
  float ds, thresh;

  // the 64 keys' (x, y), then the rows' (a, b, c)
  static constexpr int stage_size(int rows) { return BK * 8 + rows * 12; }

  __device__ bool skip(int b, int qt, int kt) const {
    return !tile_any[((long long)b * nq + qt) * cols + kt];
  }

  __device__ void fill(uint8_t* slot, int rows, int lane, int j0) const {
    float2* xy = reinterpret_cast<float2*>(slot);
    if (j0 < thw) {
      const int p0 = j0 % hw;
      const float half = __fmul_rn(ds, 0.5f);
      for (int i = lane; i < BK; i += 32) {
        const int pix = p0 + i;
        xy[i] = make_float2(__fadd_rn(__fadd_rn(__fmul_rn((float)(pix % w), ds), half), -0.5f),
                            __fadd_rn(__fadd_rn(__fmul_rn((float)(pix / w), ds), half), -0.5f));
      }
    } else {
      float* l = reinterpret_cast<float*>(slot + BK * 8);
      for (int i = lane; i < rows * 3; i += 32) l[i] = 0.f;
      const float nan = __int_as_float(0x7fc00000);
      for (int i = lane; i < BK; i += 32) xy[i] = i < nreg ? make_float2(0.f, 0.f) : make_float2(nan, nan);
    }
    __threadfence_block();
  }

  __device__ uint32_t bytes(int rows, int j0) const { return j0 < thw ? rows * 12 : 0; }

  __device__ void stage(uint8_t* slot, const CUtensorMap*, uint64_t* bar, int rows, int b, int q0, int j0) const {
    if (j0 >= thw) return;
    fence_proxy_async();  // the slot's plain writes of a register tile before the copy overwrites them
    bulk_load(slot + BK * 8, lines + (((long long)b * t + j0 / hw) * Lq + q0) * 3, rows * 12, bar);
  }

  __device__ bool tested(int, int) const { return true; }

  __device__ bool visible(const uint8_t* slot, int r, int c, int, int) const {
    const float2 xy = reinterpret_cast<const float2*>(slot)[c];
    const float* l = reinterpret_cast<const float*>(slot + BK * 8) + 3 * r;
    return fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l[0], xy.x), __fmul_rn(l[1], xy.y)), l[2])) < thresh;
  }

  __device__ void score(const uint8_t*, int, int, int, float&, float&) const {}
};

// the host-side contract of K6 and K7 (the wrappers check it first): 64-key
// tiles inside one frame, whole 128-query tiles, at most one register tile,
// the map's columns covering every key tile
inline bool epipolar_args_ok(int D, int Lq, int Lk, int t, int hw, int nreg, int cols) {
  return D % 16 == 0 && D > 0 && D <= 128 && hw % BK == 0 && Lq % BQ == 0 && nreg >= 0 && nreg <= BK &&
         Lk == t * hw + nreg && cols == t * hw / BK + 1;
}

// the policy of (B, Lq, ...) queries over t frames of hw keys + nreg
inline LineMask make_line_mask(const void* lines_t, const void* tile_any, int Lq, int t, int hw, int w, int nreg,
                               int cols, float ds, float thresh) {
  return LineMask{(const int*)tile_any, (const float*)lines_t, Lq / BQ, cols, Lq, t, t * hw, hw, w, nreg,
                  ds, thresh};
}

// ---------------------------------------------------------------- K6p's penalties

// Each frame key's logit is raised by its bf16 additive penalty (0 visible,
// -1e30 hidden, or any finite value), read from a (pb, Lq, t*hw) array built
// once per request (ops/epipolar_flash.py::materialize_penalties); batch b
// reads penalty batch b % pb, so the fused-CFG batch of 2B streams one copy.
// The penalty is added to the scaled product, in the logit's units (q
// arrives pre-scaled, as in the JAX kernel). The `nreg` register keys after
// the frames take no penalty and are always visible; keys at or past Lk are
// masked, since TMA fills the rows of K and V past Lk with zeros.
//
// A ring slot holds the tile's (rows x BK) penalties, one TMA box from the
// 3-D tensor map `penalty_map` at (key j0, query q0, batch b % pb): BK bf16
// keys are one 128-byte row, written in the 128B swizzle (16-byte chunk c
// of row r at chunk c ^ (r % 8)), so the fragment's (row, column) is read
// through `tile_offset`, a key pair at a time, and the 8 rows of a quad's
// column fall on 8 distinct chunks. The register tile (j0 >= t*hw) stages
// nothing: `score` reads the slot only for frame tiles. Skipping reads the
// same hull map at the kernels' tiling as K6 (`tile_any`, the register
// column last).
struct PenaltyMask {
  const int* tile_any;  // (B, nq, cols)
  int nq, cols, thw, pb;

  static constexpr int stage_size(int rows) { return rows * BK * 2; }

  __device__ bool skip(int b, int qt, int kt) const {
    return !tile_any[((long long)b * nq + qt) * cols + kt];
  }

  __device__ void fill(uint8_t*, int, int, int) const {}

  __device__ uint32_t bytes(int rows, int j0) const { return j0 < thw ? rows * BK * 2 : 0; }

  __device__ void stage(uint8_t* slot, const CUtensorMap* map, uint64_t* bar, int, int b, int q0, int j0) const {
    if (j0 < thw) tma_load_3d(slot, map, bar, j0, q0, b % pb);
  }

  __device__ bool tested(int j0, int Lk) const { return j0 + BK > Lk; }

  __device__ bool visible(const uint8_t*, int, int c, int j0, int Lk) const { return j0 + c < Lk; }

  // keys c and c + 1 (c even) of row r: one 4-byte bf16 pair of the swizzled row
  __device__ void score(const uint8_t* slot, int r, int c, int j0, float& s0, float& s1) const {
    if (j0 >= thw) return;
    const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(slot + tile_offset(BQ, r, c));
    s0 += __low2float(pair);
    s1 += __high2float(pair);
  }
};

// the (pb, Lq, thw) bf16 penalties, box (BK keys, rows, 1), 128B swizzle;
// false on failure
inline bool penalty_map(CUtensorMap* map, const void* ptr, int pb, int Lq, int thw, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)thw, (cuuint64_t)Lq, (cuuint64_t)pb};
  const cuuint64_t strides[2] = {(cuuint64_t)thw * 2, (cuuint64_t)Lq * thw * 2};
  const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hflash
