// The epipolar mask policy of K6 (forward) and K7 (backward), one copy of the
// distance formula for both, so the backward recomputes the forward's bits.
//
// Key j < t*hw of frame f = j / hw is visible to query i when
// |a*px + b*py + c| < ds*sqrt(2)/2, (a, b, c) = lines[b, i, f] (f32) and
// (px, py) the image coordinates of pixel j % hw; the distance is formed as
// __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c), the order the
// plain twin uses in eager torch, so no FMA contraction flips a borderline
// bit; NaN lines (F == 0) compare false and hide their whole frame. The
// `nreg` keys after the frames (register tokens) are always visible.
//
// Skipping: `tile_any` (B, Lq/block_q, cols) marks the SUBTILE-wide key
// ranges that can be visible to a block_q-query tile (hull bound, exactly
// safe). A 64-query tile reads the bit of its enclosing block_q tile (a
// superset) for the subtile j0 / sub that holds its 64-key tile; each key
// picks its line by its own frame (j / hw), so the ds16 layout, where one
// canonical key tile spans four frames, needs no special case.
#pragma once

#include "flash_core.cuh"

// floats of the policy's staging area: 64 query lines (a, b, c), then the
// 64 keys' x and y image coordinates
constexpr int STAGE_FLOATS = flash::BQ * 3 + 2 * flash::BK;

struct LineMask {
  const float* lines;    // (B, Lq, t, 3)
  const int* tile_any;   // (B, Lq / block_q, cols)
  int Lq, t, thw, hw, w, nreg, block_q, sub, cols, nqb;
  float ds, thresh;
  float* sl;  // staged lines of the tile's queries
  float* kx;  // staged key coordinates
  float* ky;

  __device__ bool skip(int b, int qt, int kt) const {
    const int row = qt * flash::BQ / block_q;
    const int col = kt * flash::BK / sub;
    return !tile_any[((long long)b * nqb + row) * cols + col];
  }

  __device__ void stage(int b, int q0, int j0) const {
    if (j0 >= thw) return;  // register tile: no geometry
    const int f = j0 / hw, p0 = j0 % hw;
    for (int i = threadIdx.x; i < flash::BQ * 3; i += blockDim.x) {
      const int r = i / 3, c = i % 3;
      const int qq = q0 + r;
      sl[i] = qq < Lq ? lines[(((long long)b * Lq + qq) * t + f) * 3 + c] : __int_as_float(0x7fc00000);
    }
    // pix2coord: x * ds + ds / 2 - 0.5, left to right in f32
    for (int i = threadIdx.x; i < flash::BK; i += blockDim.x) {
      const int pix = p0 + i;
      const float half_ds = __fmul_rn(ds, 0.5f);
      kx[i] = __fadd_rn(__fadd_rn(__fmul_rn((float)(pix % w), ds), half_ds), -0.5f);
      ky[i] = __fadd_rn(__fadd_rn(__fmul_rn((float)(pix / w), ds), half_ds), -0.5f);
    }
  }

  __device__ bool visible(int, int rb, int, int kj) const {
    if (kj >= thw) return kj - thw < nreg;
    const int i = kj & (flash::BK - 1);
    const float* l = sl + rb * 3;
    const float dist = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l[0], kx[i]), __fmul_rn(l[1], ky[i])), l[2]));
    return dist < thresh;
  }
};

// the policy over the staging area at `stage` (STAGE_FLOATS floats)
__device__ __forceinline__ LineMask make_line_mask(const float* lines, const int* tile_any, int Lq, int t, int hw,
                                                   int w, int nreg, int block_q, int sub, int cols, float ds,
                                                   float thresh, float* stage) {
  return LineMask{lines, tile_any, Lq, t, t * hw, hw, w, nreg, block_q, sub, cols, Lq / block_q,
                  ds, thresh, stage, stage + flash::BQ * 3, stage + flash::BQ * 3 + flash::BK};
}

// the host-side contract of K6 and K7 (the wrappers check it first)
inline bool epipolar_args_ok(int D, int hw, int sub, int block_q, int nreg, int Lk, int t) {
  return D % 16 == 0 && D <= 128 && hw % flash::BK == 0 && sub % flash::BK == 0 && block_q % flash::BQ == 0 &&
         nreg >= 0 && nreg <= flash::BK && Lk == t * hw + nreg;
}
