// K2: online-softmax (flash) attention forward over (B, L, H, D) bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/flash_attention.py::
// _fwd_kernel_nomask / _fwd_kernel / _fwd_kernel_sparse (entry
// flash_attention). Same arithmetic (flash_hopper.cuh): q pre-scaled in bf16,
// QK^T and PV bf16 products accumulated in f32, the running max floored at
// -1e20 so masked logits (-1e30) give exactly 0, an optional (B, Lq, Lk) bool
// mask shared by the heads, key tiles whose mask tile is empty skipped (the
// TPU kernel's scalar-prefetched bitmap), keys past Lk masked, fully masked
// rows 0. For the training backward (K5) it also writes each row's
// logsumexp, as the TPU kernel's `with_stats` variant does.
//
// On the H100 the op is tensor-core bound at the UNet's long spatial
// self-attention (L = 1024: 4 D operations per pair against 4 D bytes per
// row) and bound by reading Q and writing O at the short cross-attention
// keys (77 text tokens). The kernel is the Hopper core's forward body
// (flash_hopper_kernels.cuh: a TMA producer warp, two wgmma consumer
// warpgroups of 64 query rows, the softmax in registers, two blocks per SM)
// under the `BoolMask` policy, whose producer stages each key tile's mask
// tile by TMA beside K and V.
#include "flash_hopper_kernels.cuh"

using namespace hflash;

// q (B, Lq, H, D), k/v (B, Lk, H, D), out (B, Lq, H, D): contiguous bf16,
// 16-byte aligned. mask: optional (B or 1, nq * 128, nk * 64) uint8, the
// (B|1, Lq, Lk) bool mask zero-padded to whole tiles, with batch stride
// mask_bstride (0: shared by the batch); tile_any: optional (B, nq, nk)
// uint8 non-empty-tile map over 128 x 64 tiles (nq = ceil(Lq/128),
// nk = ceil(Lk/64)). lse: (B, H, Lq) f32 or null (the generation path).
// `scale` is the bf16-rounded softmax scale. D must be a multiple of 16,
// <= 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* mask, const void* tile_any,
                         void* out, void* lse, int B, int Lq, int Lk, int H, int D, float scale,
                         long long mask_bstride, void* stream) {
  if (D % 16 != 0 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK;
  CUtensorMap tq, tk, tv, tm = {};
  if (!bf16_map(&tq, q, B, Lq, H, D, BQ) || !bf16_map(&tk, k, B, Lk, H, D, BK) || !bf16_map(&tv, v, B, Lk, H, D, BK))
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && !mask_map(&tm, mask, mask_bstride == 0 ? 1 : B, nq * BQ, nk * BK, BQ))
    return (int)cudaErrorInvalidValue;
  const FwdParams<BoolMask> p{BoolMask{(const uint8_t*)tile_any, nq, nk, mask != nullptr, mask_bstride == 0},
                              (bf16*)out, (float*)lse, Lq, Lk, H, D, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return padded_d(D) == 64 ? launch_fwd<64>(tq, tk, tv, tm, p, B, s) : launch_fwd<128>(tq, tk, tv, tm, p, B, s);
}
