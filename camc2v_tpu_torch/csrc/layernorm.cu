// K8: row LayerNorm with f32 statistics over (R, C), output in x's dtype.
//
// Replaces the Pallas kernel camc2v_tpu/ops/layernorm.py::_ln_kernel (entry
// layer_norm_fused). The kernel, `ln::ln_rows` in layernorm.cuh (shared with
// the LayerNorm pass of K3 and K4): per row, mean = sum(x) / C,
// var = sum((x - mean)^2) / C (the exact two-pass variance),
// y = (x - mean) * rsqrt(var + eps) * scale + bias, all in f32, then rounded
// to x's dtype.
//
// Bound on the H100 by HBM bytes: x read once and y written once (no
// matmul). The TPU kernel moved (rows, C) tiles through VMEM; here a row is
// held in the registers of the few lanes that own it (a power of two, by
// the row's 16-byte pieces: 8 lanes at C = 320 bf16, 32 at 1280), read and
// written with 16-byte accesses.
#include "layernorm.cuh"

// x, y (rows, c) contiguous, bf16 (is_bf16) or f32; scale, bias (c,) f32;
// all on 16-byte boundaries; c whole 16-byte pieces, at most 512 of them
// (the wrapper checks).
extern "C" int ln_forward(const void* x, const void* scale, const void* bias, void* y, long long rows, int c,
                          float eps, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return ln::launch<bf16>((const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)y, rows, c, eps, s);
  return ln::launch<float>((const float*)x, (const float*)scale, (const float*)bias, (float*)y, rows, c, eps, s);
}
