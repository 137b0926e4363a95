// K4: LayerNorm + GEGLU feed-forward with residual.
//
// Replaces the Pallas kernel camc2v_tpu/ops/geglu_ff.py::_kernel (entry
// fused_ln_geglu_ff):
//   xn = bf16(LN_f32(x))                       two-pass f32 statistics
//   [a, g] = xn @ Wp + bp                      f32 accumulation
//   hidden = bf16(a * gelu_erf(g))             exact erf (erff of g / sqrt 2,
//                                              as g * 0.70710678), not the
//                                              TPU kernel's polynomial
//   out = bf16(hidden @ Wf + bf + f32(x))
//
// Bound on the H100 by operations: 24 rows C^2 (2 rows C 8C for the
// projection to [a, g], 2 rows 4C C for fc2), 0.0814 ms at every full-width
// site of the model (32768 x 320, 8192 x 640, 2048 x 1280 rows x C). The TPU
// kernel kept the (rows, 4C) hidden layer in VMEM; on Hopper one block cannot
// hold a useful row tile's output accumulator (64 x C f32 per warpgroup is
// C / 2 registers a thread) or its bf16 LN rows at C = 1280, and a block per
// few rows leaves most SMs idle at the deep levels. So K4 is three launches
// on the caller's stream, one design for every C, each with enough
// independent tiles to fill the card:
//   1. ln::ln_rows (layernorm.cuh, K8's kernel): bf16 xn to scratch;
//   2. the GEMM core (gemm_hopper.cuh) with the Geglu epilogue: an output
//      tile pairs the a columns [j, j + 128) with the g columns
//      [inner + j, inner + j + 128) of Wp (two TMA boxes into one stage, one
//      m64n256 accumulator per warpgroup); the epilogue forms
//      bf16(a * gelu(g)) in registers and writes the bf16 hidden tile to
//      scratch (84 MB at 32768 x 320: one write and one read through HBM,
//      ~50 us of the 3.35 TB/s; 21 MB at C = 1280, L2-resident);
//   3. the GEMM core with the BiasResidual epilogue over the hidden layer:
//      bf16(hidden @ Wf^T + bf + f32(x)), tiles of 160 output columns where
//      160 divides C, else 128.
// Tiles of GEMM 1 at 128 x 128 hidden columns: 2560 at C = 320, 640 at
// C = 1280 (2048 rows), 160 at the 4 x 4 middle level (512 rows); GEMM 2's
// K is split where its tiles fill less than half the card. (64-column GEMM-1
// tiles, twice as many at the small sites, measured slower at every site.)
#include "gemm_hopper.cuh"
#include "layernorm.cuh"

#ifndef GEGLU_STAGES
#define GEGLU_STAGES 4
#endif

namespace {

using namespace hgemm;

// hidden (rows, inner) = bf16(a * gelu_erf(g)), [a, g] = acc + bp: N tile tn
// holds hidden columns [128 tn, 128 tn + 128), i.e. accumulator columns
// 0..127 are a and 128..255 the matching g
struct Geglu {
  static constexpr int HID = 128;  // hidden columns of a tile
  static constexpr int BN = 2 * HID;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGES = GEGLU_STAGES;
  static constexpr int SCRATCH = 64 * HID * 2;
  const float* bias;  // (2 inner) f32
  bf16* hidden;
  int rows, inner;

  __device__ void load_b(unsigned char* dst, const Maps& m, uint64_t* bar, int tn, int k0) const {
    tma_load_2d(dst, &m.b[0], bar, k0, tn * HID);
    tma_load_2d(dst + HID * 128, &m.b[0], bar, k0, inner + tn * HID);
  }

  __device__ void apply(float (&acc)[BN / 2], unsigned char* scratch, long long row0, int tn, int, int wg) const {
    const int t = threadIdx.x % 128, r0 = acc_row(t), c0 = acc_col(t);
    named_barrier(1 + wg, 128);  // the previous tile's stores have read the scratch
#pragma unroll
    for (int i = 0; i < HID / 8; ++i) {
      const int c = 8 * i + c0, col = tn * HID + c;
      const float ba0 = bias[col], ba1 = bias[col + 1];
      const float bg0 = bias[inner + col], bg1 = bias[inner + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 4 * i + 2 * h, jg = j + 4 * (HID / 8);
        const float a0 = acc[j] + ba0, a1 = acc[j + 1] + ba1;
        const float g0 = acc[jg] + bg0, g1 = acc[jg + 1] + bg1;
        const float h0 = a0 * (g0 * 0.5f * (1.f + erff(g0 * 0.70710678f)));
        const float h1 = a1 * (g1 * 0.5f * (1.f + erff(g1 * 0.70710678f)));
        *reinterpret_cast<uint32_t*>(scratch + tile_offset(64, r0 + 8 * h, c)) = pack_bf16(h0, h1);
      }
    }
    named_barrier(1 + wg, 128);
    store_tile<HID>(scratch, hidden, row0, tn * HID, rows, inner, inner, t);
  }
};

}  // namespace

// x (rows, C) bf16; ln_s/ln_b (C) f32; wp (2*inner, C) and wf (C, inner) bf16
// in the torch Linear (out, in) layout; bp (2*inner) and bf (C) f32; out
// (rows, C) bf16; scratch xn (rows, C) and hidden (rows, inner) bf16, and
// with splits > 1 ws (splits, rows, C) f32; splits: GEMM 2's split of K (1,
// 2, 4 or 8). Every pointer 16-byte aligned; C % 64 == 0, inner % 128 == 0.
extern "C" int geglu_ff_fwd(const void* x, const void* ln_s, const void* ln_b, const void* wp, const void* bp,
                            const void* wf, const void* bfo, void* out, void* xn, void* hidden, void* ws, int rows,
                            int c_in, int inner, int c_out, int splits, float eps, void* stream) {
  if (c_in != c_out || c_in % BK || inner % Geglu::HID || rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = ln::launch<bf16>((const bf16*)x, (const float*)ln_s, (const float*)ln_b, (bf16*)xn, rows, c_in, eps, st);
  if (err) return err;
  Maps m{};
  if (!bf16_map_2d(&m.a, xn, rows, c_in, BM) || !bf16_map_2d(&m.b[0], wp, 2LL * inner, c_in, Geglu::HID))
    return (int)cudaErrorInvalidValue;
  err = launch(m, Geglu{(const float*)bp, (bf16*)hidden, rows, inner}, rows, c_in, inner / Geglu::HID, st);
  if (err) return err;
  return bias_residual(hidden, wf, (const float*)bfo, (const bf16*)x, (bf16*)out, rows, inner, c_out, splits,
                       (float*)ws, st);
}
