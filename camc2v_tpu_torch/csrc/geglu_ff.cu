// K4: fused LayerNorm + GEGLU feed-forward with residual.
//
// Replaces the Pallas kernel camc2v_tpu/ops/geglu_ff.py::_kernel (entry
// fused_ln_geglu_ff):
//   xn = bf16(LN_f32(x))                       two-pass f32 statistics
//   [a, g] = xn @ Wp + bp                      f32 accumulation
//   hidden = bf16(a * gelu_erf(g))             exact erf (erff), not the
//                                              TPU kernel's polynomial
//   out = hidden @ Wf + bf + x                 f32, cast to x.dtype
// The (rows, 4C) hidden layer never goes to HBM.
//
// On the H100 this is a chain of two GEMMs with a large middle dimension
// (4C; 24 rows * C^2 FLOPs per call), bound by how fast the weights reach
// the tensor cores: every block streams all of Wp and Wf (12 C^2 bf16, 39 MB
// at C = 1280) from L2, and the rows a block owns are the reuse of each
// weight byte. A block of 16 warps owns BM rows (128 at C = 320, 64 at 640,
// 32 at 1280: BM * C = 40960) and keeps its (BM, C) f32 output accumulator in
// registers (ten 16x16 fragments per warp) for the whole walk over the hidden
// dimension in chunks of BH = 32 (weight_stream.cuh):
//   GEMM1  (BM, 2*BH) = xn @ [Wp a-chunk | Wp g-chunk], C in slices of 64
//   GEGLU  -> bf16 hidden tile (BM, BH) in shared memory
//   GEMM2  acc += hidden @ Wf chunk; the (C, BH) chunk is loaded while
//          GEMM1 runs
// WMMA 16x16x16 bf16 with f32 accumulators. wgmma/TMA is later work.
#include "weight_stream.cuh"

using namespace nvcuda;

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int BH = 32;            // hidden columns per chunk
constexpr int MAXF = 10;          // output accumulator fragments per warp
constexpr int G1F = 2;            // GEMM1 fragments per warp (BM <= 128)
constexpr int LDH = 2 * BH + 4;   // GEMM1 result row (f32)
constexpr int LDG = BH + 8;       // hidden tile row (bf16)

struct Layout {
  int BM, ldx;
  size_t xn, ring, wf, h, hid, total;
};

__host__ __device__ inline Layout make_layout(int BM, int c) {
  Layout L;
  L.BM = BM;
  L.ldx = c + 8;
  L.xn = 0;
  L.ring = L.xn + align128((size_t)BM * L.ldx * 2);
  L.wf = L.ring + align128(ws::ring_bytes());
  L.h = L.wf + align128(ws::chunk_bytes(c));
  L.hid = L.h + align128((size_t)BM * LDH * 4);
  L.total = L.hid + align128((size_t)BM * LDG * 2);
  return L;
}

__global__ void __launch_bounds__(THREADS, 1)
geglu_ff_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                const bf16* __restrict__ wp, const float* __restrict__ bp, const bf16* __restrict__ wf,
                const float* __restrict__ bfo, bf16* __restrict__ out, long long rows, int c, int inner,
                float eps, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * L.BM;
  bf16* xn = reinterpret_cast<bf16*>(smem + L.xn);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  bf16* wfs = reinterpret_cast<bf16*>(smem + L.wf);
  float* hbuf = reinterpret_cast<float*>(smem + L.h);
  bf16* hid = reinterpret_cast<bf16*>(smem + L.hid);

  for (int r = warp; r < L.BM; r += WARPS) {
    bf16* dst = xn + r * L.ldx;
    if (r0 + r < rows) {
      warp_layernorm_row(x + (r0 + r) * c, dst, c, ln_s, ln_b, eps, lane);
    } else {
      for (int i = lane; i < c; i += 32) dst[i] = __float2bfloat16(0.f);
    }
  }

  const int m_tiles = L.BM / 16, n_tiles = c / 16;
  ws::Acc acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int chunk = 0; chunk < inner / BH; ++chunk) {
    __syncthreads();  // the previous chunk is done with wfs and hid; xn is ready
    ws::load_cols32<WARPS>(wf, inner, c, chunk * BH, wfs);
    ws::Acc g1[G1F];
    ws::gemm_rows64<WARPS>(xn, L.ldx, m_tiles, c, [&](int r) {
      return wp + (long long)(r < BH ? chunk * BH + r : inner + chunk * BH + (r - BH)) * c;
    }, ring, g1);
#pragma unroll
    for (int f = 0; f < G1F; ++f) {
      const int t = warp + f * WARPS;
      if (t < m_tiles * 4) {
        wmma::store_matrix_sync(hbuf + (t / 4) * 16 * LDH + (t % 4) * 16, g1[f], LDH, wmma::mem_row_major);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < L.BM * BH; e += THREADS) {
      const int r = e / BH, cc = e % BH;
      const float a = hbuf[r * LDH + cc] + bp[chunk * BH + cc];
      const float g = hbuf[r * LDH + BH + cc] + bp[inner + chunk * BH + cc];
      const float gelu = g * 0.5f * (1.f + erff(g / 1.41421356f));
      hid[r * LDG + cc] = __float2bfloat16(a * gelu);
    }
    __syncthreads();  // hid ready; the Wf chunk landed inside gemm_rows64
    ws::mma_k32<WARPS>(hid, LDG, m_tiles, n_tiles, wfs, acc);
  }

  __syncthreads();  // wfs and what follows become the epilogue staging area
  ws::store_rows<WARPS>(acc, reinterpret_cast<float*>(wfs), m_tiles, n_tiles,
                        [&](int r) { return r0 + r < rows ? r0 + r : -1LL; }, bfo, x, c, out, c);
}

}  // namespace

// x (rows, C) bf16; ln_s/ln_b (C) f32; wp (2*inner, C) and wf (C, inner) bf16 in
// the torch Linear (out, in) layout; bp (2*inner) and bf (C) f32;
// out (rows, C) bf16. C % 64 == 0, C <= 1280 (shared memory), inner % 32 == 0;
// 16-byte aligned weights.
extern "C" int geglu_ff_fwd(const void* x, const void* ln_s, const void* ln_b, const void* wp,
                            const void* bp, const void* wf, const void* bfo, void* out, long long rows,
                            int c_in, int inner, int c_out, float eps, void* stream) {
  if (c_in != c_out || c_in % ws::KS || inner % BH) return (int)cudaErrorInvalidValue;
  // largest BM whose output tiles fit MAXF fragments per warp
  int BM = 128;
  while (BM > 16 && (BM / 16) * (c_in / 16) > MAXF * WARPS) BM /= 2;
  if ((BM / 16) * (c_in / 16) > MAXF * WARPS) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(BM, c_in);
  // the epilogue stages WARPS 16x16 f32 tiles where Wf, h and hid were
  if (L.total > 227 * 1024 || L.total - L.wf < (size_t)WARPS * 256 * 4) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(geglu_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  RETURN_IF_ERR();
  const long long blocks = (rows + BM - 1) / BM;
  geglu_ff_kernel<<<(unsigned)blocks, THREADS, L.total, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_s, (const float*)ln_b, (const bf16*)wp, (const float*)bp,
      (const bf16*)wf, (const float*)bfo, (bf16*)out, rows, c_in, inner, eps, L);
  RETURN_IF_ERR();
  return 0;
}
