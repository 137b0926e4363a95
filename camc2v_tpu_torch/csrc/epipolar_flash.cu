// K6: epipolar flash attention forward, the mask recomputed from epipolar
// lines inside the kernel, over (B, L, H, D) bf16.
//
// Replaces the Pallas kernel camc2v_tpu/ops/epipolar_flash.py::_v2_kernel
// (entry epipolar_flash_attention, in-kernel mask path). What it computes:
// attention of q (B, Lq, H, D) over k/v (B, t*hw + nreg, H, D) under the
// line-distance mask of epipolar_mask.cuh (register keys last, always
// visible; subtiles the hull map marks empty are skipped and load nothing),
// and, for the training backward (K7), the rows' logsumexp.
//
// The TPU kernel's 256 x 1024 tiles, whole-key-axis VMEM residency and head
// groups do not carry over: this is the online-softmax core of K2
// (flash_core.cuh) with the line-distance mask policy. The masks are sparse
// (a few percent of the bits set), so the op's least time is set by its
// bytes; the 256 x 256 skip map leaves far more pairs on than the mask
// keeps, and the core's WMMA tiles with scores in shared memory reach a
// fraction of the bf16 peak. A finer skip map and wgmma/TMA are later work.
#include "epipolar_mask.cuh"

namespace {

__global__ void __launch_bounds__(flash::WARPS * 32)
epipolar_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ lines, const int* __restrict__ tile_any,
                    bf16* __restrict__ out, float* __restrict__ lse, int Lq, int Lk, int H, int D, int t, int hw,
                    int w, int nreg, int block_q, int sub, int cols, float scale, float ds, float thresh) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + flash::core_smem_bytes(D));
  LineMask m = make_line_mask(lines, tile_any, Lq, t, hw, w, nreg, block_q, sub, cols, ds, thresh, stage);
  const int lk_valid = t * hw + nreg;
  const int nk = (lk_valid + flash::BK - 1) / flash::BK;
  flash::attention_body(q, k, v, out, lse, Lq, Lk, lk_valid, H, D, scale, nk, smem, m, blockIdx.x, blockIdx.y,
                        blockIdx.z);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H, D), out (B, Lq, H, D):
// contiguous bf16. lines (B, Lq, t, 3) f32; tile_any (B, Lq / block_q, cols)
// int32 with cols = (t*hw + block_k) / sub, the register column at
// t*hw / sub. hw and sub multiples of 64, block_q a multiple of 64,
// nreg <= 64, D a multiple of 16 up to 128 (the wrapper checks).
// lse: (B, H, Lq) f32 or null (the generation path).
// `scale` is the bf16-rounded softmax scale; `thresh` = ds*sqrt(2)/2 in f32.
extern "C" int epipolar_flash_fwd(const void* q, const void* k, const void* v, const void* lines,
                                  const void* tile_any, void* out, void* lse, int B, int Lq, int Lk, int H, int D,
                                  int t, int hw, int w, int nreg, int block_q, int sub, int cols,
                                  float scale, float ds, float thresh, void* stream) {
  if (!epipolar_args_ok(D, hw, sub, block_q, nreg, Lk, t)) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ;
  const size_t smem = flash::core_smem_bytes(D) + STAGE_FLOATS * sizeof(float);
  cudaFuncSetAttribute(epipolar_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RETURN_IF_ERR();
  dim3 grid(nq, H, B);
  epipolar_fwd_kernel<<<grid, flash::WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lines, (const int*)tile_any, (bf16*)out,
      (float*)lse, Lq, Lk, H, D, t, hw, w, nreg, block_q, sub, cols, scale, ds, thresh);
  RETURN_IF_ERR();
  return 0;
}
