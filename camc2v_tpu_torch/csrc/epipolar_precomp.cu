// K6p: epipolar flash attention forward with the mask read from precomputed
// bf16 additive penalties, over (B, L, H, D) bf16.
//
// Replaces the Pallas kernel camc2v_tpu/ops/epipolar_flash.py::_v2p_kernel
// (entry epipolar_flash_attention with `penalties`): K6's online softmax and
// skip map, with each frame key's logit raised by its penalty instead of
// the line distance computed in the kernel. Inference only: with a gradient
// wanted the wrapper recomputes the forward on the lines' mask for K7.
//
// The op is bound by bytes: at ds8 the penalty tiles the skip map leaves on
// (89 MiB at batch 2 on the bench trajectory) outweigh q, k and v. It runs
// on the Hopper core's forward body (flash_hopper_kernels.cuh) under the
// `PenaltyMask` policy of epipolar_mask.cuh: the producer warp streams each
// tile's 128 x 64 penalties (16 KB) by TMA beside K and V into the ring, and
// the consumers add them to the scaled products in registers, one add per
// pair where K6 tests a line distance. The core's grid (H, Lq / 128, B)
// puts the heads of a query tile next to each other in launch order, so
// each penalty tile comes from device memory about once and from L2 for the
// other heads.
#include "epipolar_mask.cuh"
#include "flash_hopper_kernels.cuh"

using namespace hflash;

// q (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H, D), out (B, Lq, H, D):
// contiguous bf16, 16-byte aligned. pen (pb, Lq, t*hw) contiguous bf16,
// 16-byte aligned, B % pb == 0; tile_any (B, Lq / 128, cols) int32, the hull
// map over 128 x 64 tiles with cols = t*hw / 64 + 1 (the register column
// last). hw a multiple of 64, Lq of 128, nreg <= 64, D a multiple of 16 up
// to 128. `scale` is the bf16-rounded softmax scale.
extern "C" int epipolar_precomp_fwd(const void* q, const void* k, const void* v, const void* pen,
                                    const void* tile_any, void* out, int B, int Lq, int Lk, int H, int D, int t,
                                    int hw, int nreg, int pb, int cols, float scale, void* stream) {
  if (!epipolar_args_ok(D, Lq, Lk, t, hw, nreg, cols) || pb < 1 || B % pb != 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tp;
  if (!bf16_map(&tq, q, B, Lq, H, D, BQ) || !bf16_map(&tk, k, B, Lk, H, D, BK) ||
      !bf16_map(&tv, v, B, Lk, H, D, BK) || !penalty_map(&tp, pen, pb, Lq, t * hw, BQ))
    return (int)cudaErrorInvalidValue;
  const FwdParams<PenaltyMask> p{PenaltyMask{(const int*)tile_any, Lq / BQ, cols, t * hw, pb}, (bf16*)out, nullptr,
                                 Lq, Lk, H, D, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return padded_d(D) == 64 ? launch_fwd<64>(tq, tk, tv, tp, p, B, s) : launch_fwd<128>(tq, tk, tv, tp, p, B, s);
}

namespace {

template <int DP>
int occupancy(int* smem, int* blocks_per_sm) {
  *smem = FwdSmem<DP, PenaltyMask>::bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<DP, PenaltyMask>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  RETURN_IF_ERR();
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, flash_fwd_kernel<DP, PenaltyMask>, FWD_THREADS, *smem);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

// K6p's launch at head dim D: the dynamic shared memory of a block and the
// blocks an SM holds at once (registers and shared memory together)
extern "C" int epipolar_precomp_occupancy(int D, int* smem, int* blocks_per_sm) {
  if (D % 16 != 0 || D <= 0 || D > 128) return (int)cudaErrorInvalidValue;
  return padded_d(D) == 64 ? occupancy<64>(smem, blocks_per_sm) : occupancy<128>(smem, blocks_per_sm);
}
