// The epipolar mask policy of K6 (forward) and K7 (backward) on the Hopper
// core (flash_hopper.cuh): one copy of the distance formula for both, so the
// backward recomputes the forward's bits.
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

  __device__ float score(int, int, float s) const { return s; }
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

}  // namespace hflash
