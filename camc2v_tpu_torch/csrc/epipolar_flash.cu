// K6: epipolar flash attention forward, the mask recomputed from epipolar
// lines inside the kernel, over (B, L, H, D) bf16.
//
// Replaces the Pallas kernel camc2v_tpu/ops/epipolar_flash.py::_v2_kernel
// (entry epipolar_flash_attention, in-kernel mask path). What it computes:
// attention of q (B, Lq, H, D) over k/v (B, t*hw + nreg, H, D) under the
// line-distance mask of epipolar_mask.cuh (register keys last, always
// visible; the 128 x 64 tiles the hull map marks empty are skipped and load
// nothing), and, for the training backward (K7), the rows' logsumexp.
//
// The TPU kernel's 256 x 1024 tiles, whole-key-axis VMEM residency and head
// groups do not carry over. The masks are sparse (3% of the bits set at the
// ds8 site), so the op's least time is set by its bytes, and what the card
// spends goes into the tiles the map leaves on: the map is built at the
// kernel's own 128 x 64 tiling, which leaves far fewer pairs on than the
// JAX map's 256 x 256 subtiles. Every tile left on runs on the
// Hopper core's forward body (flash_hopper_kernels.cuh: K, V and the tile's
// geometry streamed by a TMA producer warp, wgmma products, the softmax in
// registers) under the `LineMask` policy, which tests every pair of a tile
// from the staged lines and key coordinates.
#include "epipolar_mask.cuh"
#include "flash_hopper_kernels.cuh"

using namespace hflash;

// q (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H, D), out (B, Lq, H, D):
// contiguous bf16, 16-byte aligned. lines_t (B, t, Lq, 3) f32 (the lines
// with the frame axis ahead of the queries); tile_any (B, Lq / 128, cols)
// int32, the hull map over 128 x 64 tiles with cols = t*hw / 64 + 1 (the
// register column last). hw a multiple of 64, Lq of 128, nreg <= 64, D a
// multiple of 16 up to 128. lse: (B, H, Lq) f32 or null (the generation
// path). `scale` is the bf16-rounded softmax scale; `thresh` = ds*sqrt(2)/2
// in f32.
extern "C" int epipolar_flash_fwd(const void* q, const void* k, const void* v, const void* lines_t,
                                  const void* tile_any, void* out, void* lse, int B, int Lq, int Lk, int H, int D,
                                  int t, int hw, int w, int nreg, int cols, float scale, float ds, float thresh,
                                  void* stream) {
  if (!epipolar_args_ok(D, Lq, Lk, t, hw, nreg, cols)) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, none = {};
  if (!bf16_map(&tq, q, B, Lq, H, D, BQ) || !bf16_map(&tk, k, B, Lk, H, D, BK) || !bf16_map(&tv, v, B, Lk, H, D, BK))
    return (int)cudaErrorInvalidValue;
  const FwdParams<LineMask> p{make_line_mask(lines_t, tile_any, Lq, t, hw, w, nreg, cols, ds, thresh), (bf16*)out,
                              (float*)lse, Lq, Lk, H, D, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return padded_d(D) == 64 ? launch_fwd<64>(tq, tk, tv, none, p, B, s) : launch_fwd<128>(tq, tk, tv, none, p, B, s);
}
