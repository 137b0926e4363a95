// The Hopper attention core of K2, K5, K6 and K7: tile geometry, the mask
// policy of K2 and K5 (a bool mask shared by the heads), and the sm_90a
// building blocks their kernels are made of. The kernel bodies, templates on
// the mask policy, are in flash_hopper_kernels.cuh; K6 and K7's policy, the
// epipolar line mask, is in epipolar_mask.cuh.
//
// Tiles. Query tiles of BQ = 128 rows (the forward's block: two consumer
// warpgroups of 64 rows each) and key tiles of BK = 64 keys; the tile maps
// that skip empty tiles (`ops/flash_attention.py::_tiles`,
// `ops/epipolar_flash.py::kernel_tile_map`) are built on this grid. Every
// bf16 tile of (rows x D) lives in shared memory as DP / 64 "atoms" of
// (rows x 64) bf16, DP = D rounded up to 64, each atom 128-byte rows in the
// 128B swizzle (16-byte chunk c of row r stored at chunk c ^ (r % 8)), which
// is what a TMA copy with CU_TENSOR_MAP_SWIZZLE_128B writes and what a wgmma
// descriptor with layout type 1 reads. A tensor map over (D, H, L, B) with
// box (64, 1, rows, 1) fills one atom per copy and zero-fills the ragged row
// edge and the columns past D (D = 80 is read as two atoms, the second 16
// columns wide and 48 columns of zeros: the tensors are never padded).
//
// Products. `wgmma.mma_async` m64nNk16, bf16 inputs, f32 accumulators in
// registers. A from shared memory (K-major: Q, K, V, dO rows, D contiguous)
// or from registers (P and dS, converted from an accumulator: the m64nN
// accumulator of S is, 16 columns at a time, the register A fragment of the
// next product); B from shared memory, K-major for S = Q K^T, or MN-major
// (the transpose bit) for P V, dS K, P^T dO and dS^T Qs, where the product's
// K dimension runs over the tile's rows. Accumulator element d[4i + j] of
// thread t of the warpgroup (warp w = t / 32, lane l) sits at row
// 16 w + l / 4 + 8 (j / 2) and column 8 i + 2 (l % 4) + (j % 2), so a row's
// values are spread over the 4 threads of a quad and a row reduction is two
// xor-shuffles.
//
// The arithmetic is the JAX kernels' (and the plain twins'): q pre-scaled in
// bf16, bf16(q * bf16(scale)), before the product; f32 softmax; masked
// logits -1e30; the running max floored at -1e20 so masked logits give
// exactly 0; the row sum over the f32 probabilities and P rounded to bf16
// for the P V product only; keys at or past Lk masked (the zero-filled key
// rows would give a score of 0); a fully masked row gives 0 and lse +1e30.
// exp(x - m) is computed as exp2(x log2 e - m log2 e) with ex2.approx.
//
// The mask policy. A policy type has these members, called by the kernels:
//   static int stage_size(rows)   bytes of a ring slot's policy data for a
//                                 tile of `rows` query rows;
//   bool skip(b, qt, kt)          tile (query tile qt of BQ rows, key tile kt)
//                                 holds no visible pair: nothing is loaded;
//   void fill(slot, rows, lane, j0)  the producer warp's plain shared-memory
//                                 writes of the slot, every lane, before the
//                                 copies are issued;
//   uint32_t bytes(rows, j0)      the bytes stage() adds to the barrier;
//   void stage(slot, map, bar, rows, b, q0, j0)  the producer's
//                                 asynchronous copies of the policy's data
//                                 for one tile into the slot, on the stage's
//                                 barrier;
//   bool tested(j0, Lk)           key tile j0 has pairs whose bit must be
//                                 tested (else all its keys are visible);
//   bool visible(slot, r, c, j0, Lk)  the bit of row r (query) and key c of
//                                 the staged tile, on fragment coordinates;
//   float score(r, c, s)          the logit of a visible pair from its
//                                 scaled product s.
// K6p still runs on flash_core.cuh and its policy.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace hflash {

constexpr int BQ = 128;      // query rows of a tile (of the forward block, and of the tile map)
constexpr int BK = 64;       // keys of a tile
constexpr int STAGES = 2;    // depth of the shared-memory ring of streamed tiles
constexpr float NEG_INF = -1e30f;
constexpr float M_FLOOR = -1e20f;
constexpr float LSE_MASKED = 1e30f;  // lse of a fully masked row: exp(s - lse) == 0
constexpr float LOG2E = 1.4426950408889634f;

// D rounded up to a whole number of 64-column atoms
__host__ __device__ constexpr int padded_d(int d) { return d <= 64 ? 64 : 128; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}
// one arrival that also announces `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the barrier's phase of parity `parity` has completed; a wait
// that never ends (a broken pipeline) traps, so the launch fails with an
// error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// generic-proxy writes to shared memory made visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;" ::: "memory"); }
// barrier `id` (1..15) over `threads` threads
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- copies

// TMA: the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// the `rows` x D tile at row `row0` of (B, L, H, D) head h, as DP / 64 atoms
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int rows, int row0,
                                         int h, int b) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) tma_load_4d(dst + a * rows * 128, map, bar, a * 64, h, row0, b);
}

// byte offset of element (r, c) in a tile of `rows` rows stored as swizzled atoms
__device__ __forceinline__ int tile_offset(int rows, int r, int c) {
  return (c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// ---------------------------------------------------------------- wgmma

// shared-memory matrix descriptor, 128B swizzle; byte offsets: `lbo` between
// atoms along the MN dimension (MN-major operands), `sbo` between 8-row groups
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}
// K-major operand (rows x D, D contiguous): k-step kk of 16 columns of a
// tile of `rows` rows, starting at row `row0`
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int row0, int kk) {
  return gmma_desc(tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}
// MN-major operand (the product's K dimension over the tile's rows, N over
// D): k-step kk of 16 rows of a tile of `rows` rows
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int rows, int kk) {
  return gmma_desc(tile + kk * 16 * 128, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32 f32, registers) (+)= A (64 x 16 bf16, shared) . B (16 x 32 bf16, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 64 f32, registers) (+)= A (64 x 16 bf16, shared) . B (16 x 64 bf16, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 64 f32, registers) (+)= A (64 x 16 bf16, registers) . B (16 x 64 bf16, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 128 f32, registers) (+)= A (64 x 16 bf16, registers) . B (16 x 128 bf16, shared)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// the wrappers by accumulator size
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) { wgmma_ss_n32<TB>(d, a, b, acc); }
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_ss_n64<TB>(d, a, b, acc); }
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  wgmma_rs_n64<TB>(d, a, b, acc);
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  wgmma_rs_n128<TB>(d, a, b, acc);
}

// 16 columns (k-step kk) of an accumulator as the register A fragment of
// the next product, rounded to bf16
template <int N>
__device__ __forceinline__ void a_fragment(const float (&d)[N], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// ---------------------------------------------------------------- the mask policy of K2 and K5

// An optional (B|1, nq*BQ, nk*BK) uint8 mask (the caller's (B|1, Lq, Lk)
// bool mask zero-padded to whole tiles, shared by the heads) with its
// (B, nq, nk) non-empty-tile map. The producer stages a (rows x BK) tile of
// it into shared memory by TMA; the consumers read their fragment's bits
// there. Keys at or past Lk are zero in the padded mask; without a mask
// they are tested on the ragged last tile only.
struct BoolMask {
  const uint8_t* tile_any;  // null: no tile is skipped
  int nq, nk;
  bool on;    // a mask is given
  bool shared;  // one mask for the whole batch

  static constexpr int stage_size(int rows) { return rows * BK; }
  __device__ bool skip(int b, int qt, int kt) const {
    return tile_any != nullptr && !tile_any[((long long)b * nq + qt) * nk + kt];
  }
  __device__ void fill(uint8_t*, int, int, int) const {}
  __device__ uint32_t bytes(int rows, int) const { return on ? rows * BK : 0; }
  __device__ void stage(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int, int b, int q0, int j0) const {
    if (on) tma_load_3d(dst, map, bar, j0, q0, shared ? 0 : b);
  }
  __device__ bool tested(int j0, int Lk) const { return on || j0 + BK > Lk; }
  __device__ bool visible(const uint8_t* tile, int r, int c, int j0, int Lk) const {
    return on ? tile[r * BK + c] != 0 : j0 + c < Lk;
  }
  __device__ float score(int, int, float s) const { return s; }
};

// ---------------------------------------------------------------- tensor maps (host)

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, L, H, D) bf16, box (64, 1, rows, 1), 128B swizzle; false on failure
inline bool bf16_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the padded (Bm, rows_total, cols) uint8 mask, box (BK, rows, 1)
inline bool mask_map(CUtensorMap* map, const void* ptr, int Bm, int rows_total, int cols, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows_total, (cuuint64_t)Bm};
  const cuuint64_t strides[2] = {(cuuint64_t)cols, (cuuint64_t)rows_total * cols};
  const cuuint32_t box[3] = {BK, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hflash
