// The Hopper GEMM core of K3 and K4: out = epilogue(A @ B^T), A a (rows, K)
// bf16 activation matrix, B a bf16 weight in the torch Linear layout (n, K),
// both K-major, so a TMA box of (64 k-columns x rows) in the 128B swizzle is
// directly a wgmma operand (sm90.cuh), f32 accumulators in registers.
//
// A block: one producer warpgroup, of which one thread issues the TMA copies
// (its registers lowered to 40 with setmaxnreg), and two consumer warpgroups
// (raised to 232) that each own 64 rows of a BM = 128-row output tile. Per
// k-step of BK = 64 columns the producer copies the A tile (128 x 64) and
// the epilogue's B boxes (Epi::BN weight rows x 64) into one stage of an
// mbarrier ring (Epi::STAGES deep); the consumers run m64nBNk16 wgmma from
// shared memory, keep one k-step's products in flight
// (wgmma_wait<1>) and release a stage when its products are done. The block
// walks the output tiles persistently (tile = blockIdx.x, + gridDim.x, ...;
// the N tiles of a row tile adjacent, so the weights stay in L2 and a row
// tile's A is read from HBM once), so the producer fills the ring for the
// next tile while the consumers run the epilogue (one block per tile measured
// slower at the large K3 and K4 sites, level at the small ones).
//
// The epilogue is a template parameter. An epilogue type has:
//   BN, B_BYTES, STAGES, SCRATCH   accumulator columns (the wgmma N), bytes of
//                                  a stage's B boxes (BN x 128), the ring's
//                                  depth, shared bytes per consumer warpgroup;
//   load_b(dst, maps, bar, tn, k0) the producer's copies of N tile tn's B
//                                  boxes at k-column k0;
//   apply(acc, scratch, row0, tn, part, wg)  the warpgroup's 64 x BN
//                                  accumulator (rows row0 .. row0 + 63 of A,
//                                  k part `part`) to the output.
// BiasResidual (here; K4's second GEMM and K3's out-projection, 160 or 128
// columns a tile): bf16(acc + bias [+ f32 residual]); Geglu (geglu_ff.cu);
// QkvAttention (temporal_attention.cu). Every epilogue stages its bf16 tile
// through its scratch and stores it as 16-byte rows; rows past `rows` (read
// as zeros by TMA) are not stored.
#pragma once

#include "sm90.cuh"

#ifndef OUT_STAGES
#define OUT_STAGES 4
#endif

namespace hgemm {

using namespace sm90;

constexpr int BM = 128;  // rows of an output tile: two consumer warpgroups of 64 rows
constexpr int BK = 64;   // k-columns of a stage: one swizzled atom per operand
constexpr int CONSUMERS = 2;
constexpr int THREADS = (CONSUMERS + 1) * 128;  // plus the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;
// registers a thread: a block starts with the launch bound's 168 and the
// consumers take what the producer gives back (128 x 128 = 256 x 64)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// A's map (rows, K) with a box of (64, BM); up to three maps of weights (n, K)
struct Maps {
  CUtensorMap a;
  CUtensorMap b[3];
};

template <class Epi>
struct Smem {
  static constexpr int STAGE = A_BYTES + Epi::B_BYTES;
  static constexpr int scratch = Epi::STAGES * STAGE;
  static constexpr int bar = scratch + CONSUMERS * Epi::SCRATCH;
  static constexpr int bytes = bar + 16 * Epi::STAGES + 1024;  // + alignment slack
};

// this thread's accumulator rows (r0, r0 + 8) and first column in the warpgroup's tile
__device__ __forceinline__ int acc_row(int t) { return (t / 32) * 16 + (t % 32) / 4; }
__device__ __forceinline__ int acc_col(int t) { return 2 * (t % 4); }

// the warpgroup's staged 64 x W bf16 tile (swizzled atoms) to rows row0.. and
// columns col0.. of a row-major matrix with row stride ld, as 16-byte chunks;
// rows at or past `rows` and columns at or past `cols` are not stored
template <int W>
__device__ __forceinline__ void store_tile(const unsigned char* tile, bf16* out, long long row0, int col0, int rows,
                                           int cols, int ld, int t) {
  constexpr int CHUNKS = W / 8;
#pragma unroll 4
  for (int i = t; i < 64 * CHUNKS; i += 128) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (row0 + r < rows && col0 + c < cols)
      *reinterpret_cast<uint4*>(out + (row0 + r) * ld + col0 + c) =
          *reinterpret_cast<const uint4*>(tile + tile_offset(64, r, c));
  }
}

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ Maps maps, const Epi epi, const int rows, const int k_steps, const int tiles_n,
            const int splits) {
  using L = Smem<Epi>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned for the 128B swizzle
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar);
  uint64_t* empty = full + Epi::STAGES;
  const int tiles = (rows + BM - 1) / BM * tiles_n * splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Epi::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---------------- producer: one thread issues every copy
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS * 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int part = tile % splits, tn = tile / splits % tiles_n, tm = tile / splits / tiles_n;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % Epi::STAGES, k0 = (part * k_steps + ks) * BK;
          mbar_wait(&empty[s], ((it / Epi::STAGES) & 1) ^ 1);
          unsigned char* st = smem + s * L::STAGE;
          mbar_expect_tx(&full[s], L::STAGE);
          tma_load_2d(st, &maps.a, &full[s], k0, tm * BM);
          epi.load_b(st + A_BYTES, maps, &full[s], tn, k0);
        }
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  setmaxnreg_inc<CONSUMER_REGS>();
  unsigned char* scratch = smem + L::scratch + wg * Epi::SCRATCH;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int part = tile % splits, tn = tile / splits % tiles_n, tm = tile / splits / tiles_n;
    float acc[Epi::BN / 2];
    int held = 0;  // the stage whose products may still be in flight
    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int s = it % Epi::STAGES;
      mbar_wait(&full[s], (it / Epi::STAGES) & 1);
      const unsigned char* A = smem + s * L::STAGE;
      const unsigned char* B = A + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<0>(acc, desc_k(A, BM, wg * 64, kk), desc_k(B, Epi::BN, 0, kk), ks > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0) mbar_arrive(&empty[held]);
      held = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[held]);
    epi.apply(acc, scratch, (long long)tm * BM + wg * 64, tn, part, wg);
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// the GEMM over ceil(rows / BM) x tiles_n output tiles, K = k_steps * BK,
// each tile's k-steps split over `splits` blocks (parts). Internal linkage:
// every kernel library (a shared object loaded by ctypes) has its own copy
// of the kernel and of `ready`; a function-local static of an inline
// template would be one object for the whole process (a GNU unique
// symbol), and the second library would skip setting its own kernel's
// shared-memory attribute.
template <class Epi>
static int launch(const Maps& maps, const Epi& epi, int rows, int k, int tiles_n, cudaStream_t stream,
                  int splits = 1) {
  if (rows <= 0 || k % (BK * splits) != 0 || tiles_n <= 0) return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<Epi>::bytes;
  static_assert(smem <= 227 * 1024, "the ring and the epilogue's scratch exceed the shared memory of a block");
  static bool ready = false;  // the attribute set and the register check, once per kernel
  if (!ready) {
    cudaFuncSetAttribute(gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    RETURN_IF_ERR();
    // the consumers' setmaxnreg.inc waits for registers the producer gives
    // back: refuse a build whose launch count cannot cover it rather than hang
    cudaFuncAttributes attr;
    cudaFuncGetAttributes(&attr, gemm_kernel<Epi>);
    RETURN_IF_ERR();
    if (128 * (attr.numRegs - PRODUCER_REGS) < 2 * 128 * (CONSUMER_REGS - attr.numRegs))
      return (int)cudaErrorInvalidConfiguration;
    ready = true;
  }
  const int tiles = (rows + BM - 1) / BM * tiles_n * splits;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_kernel<Epi><<<grid, THREADS, smem, stream>>>(maps, epi, rows, k / BK / splits, tiles_n, splits);
  RETURN_IF_ERR();
  return 0;
}

// ---------------------------------------------------------------- bias (+ residual)

// out (rows, n) = bf16(acc + bias [+ f32(res)]), res (rows, n) bf16 or null;
// N tiles of BN columns: OUT_WIDE where it divides n (C = 320, 640, 1280),
// else OUT_NARROW with the last tile ragged (its weight rows past n read as
// zeros, its columns past n not stored). Where the tiles are too few to fill
// the card (the deep levels at batch 1), the wrapper splits K over `splits`
// parts: each part stores its f32 partial sums into ws (splits, rows, n) and
// out_reduce adds them, the bias and the residual.
constexpr int OUT_WIDE = 160;
constexpr int OUT_NARROW = 128;

template <int BN_>
struct BiasResidual {
  static constexpr int BN = BN_;
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGES = OUT_STAGES;
  static constexpr int SCRATCH = 64 * ((BN + 63) / 64) * 128;  // whole 64-column atoms
  const float* bias;
  const bf16* res;
  bf16* out;
  float* ws;  // split K: the parts' f32 sums; null: one part
  int rows, n;

  __device__ void load_b(unsigned char* dst, const Maps& m, uint64_t* bar, int tn, int k0) const {
    tma_load_2d(dst, &m.b[0], bar, k0, tn * BN);
  }

  __device__ void apply(float (&acc)[BN / 2], unsigned char* scratch, long long row0, int tn, int part,
                        int wg) const {
    const int t = threadIdx.x % 128, r0 = acc_row(t), c0 = acc_col(t);
    if (ws != nullptr) {
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int col = tn * BN + 8 * i + c0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + r0 + 8 * h;
          if (col < n && row < rows)
            *reinterpret_cast<float2*>(ws + ((long long)part * rows + row) * n + col) =
                make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        }
      }
      return;
    }
    named_barrier(1 + wg, 128);  // the previous tile's stores have read the scratch
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int c = 8 * i + c0, col = tn * BN + c;
      const bool live = col < n;
      const float b0 = live ? bias[col] : 0.f, b1 = live ? bias[col + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        float v0 = acc[4 * i + 2 * h] + b0, v1 = acc[4 * i + 2 * h + 1] + b1;
        if (res != nullptr && live && row0 + r < rows) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + (row0 + r) * n + col));
          v0 += x.x;
          v1 += x.y;
        }
        *reinterpret_cast<uint32_t*>(scratch + tile_offset(64, r, c)) = pack_bf16(v0, v1);
      }
    }
    named_barrier(1 + wg, 128);
    store_tile<BN>(scratch, out, row0, tn * BN, rows, n, n, t);
  }
};

// out = bf16(sum of the splits parts of ws + bias [+ f32(res)]), 8 columns a thread
__global__ void __launch_bounds__(256)
out_reduce(const float* __restrict__ ws, int splits, const float* __restrict__ bias, const bf16* __restrict__ res,
           bf16* __restrict__ out, int rows, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x, chunks = (long long)rows * (n / 8);
  if (i >= chunks) return;
  const long long o = i * 8;
  const int col = (int)(o % n);
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = 0.f;
  for (int p = 0; p < splits; ++p) {
    const float4* w = reinterpret_cast<const float4*>(ws + (long long)p * rows * n + o);
    const float4 a = w[0], b = w[1];
    v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w, v[4] += b.x, v[5] += b.y, v[6] += b.z, v[7] += b.w;
  }
  uint4 x = make_uint4(0, 0, 0, 0);
  if (res != nullptr) x = *reinterpret_cast<const uint4*>(res + o);
  const __nv_bfloat162* xe = reinterpret_cast<const __nv_bfloat162*>(&x);
  uint4 y;
  uint32_t* ye = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 r = __bfloat1622float2(xe[j]);
    ye[j] = pack_bf16(v[2 * j] + bias[col + 2 * j] + r.x, v[2 * j + 1] + bias[col + 2 * j + 1] + r.y);
  }
  *reinterpret_cast<uint4*>(out + o) = y;
}

// a (rows, k) @ w (n, k)^T + bias [+ res] -> out (rows, n): the maps made
// here, the N tile by n; with splits > 1, ws holds (splits, rows, n) f32
inline int bias_residual(const void* a, const void* w, const float* bias, const bf16* res, bf16* out, int rows, int k,
                         int n, int splits, float* ws, cudaStream_t stream) {
  const int bn = n % OUT_WIDE == 0 ? OUT_WIDE : OUT_NARROW;
  if (splits < 1 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  Maps m{};
  if (!bf16_map_2d(&m.a, a, rows, k, BM) || !bf16_map_2d(&m.b[0], w, n, k, bn)) return (int)cudaErrorInvalidValue;
  const int tiles_n = (n + bn - 1) / bn;
  float* parts = splits > 1 ? ws : nullptr;
  const int err =
      bn == OUT_WIDE
          ? launch(m, BiasResidual<OUT_WIDE>{bias, res, out, parts, rows, n}, rows, k, tiles_n, stream, splits)
          : launch(m, BiasResidual<OUT_NARROW>{bias, res, out, parts, rows, n}, rows, k, tiles_n, stream, splits);
  if (err || splits == 1) return err;
  const long long chunks = (long long)rows * (n / 8);
  out_reduce<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(ws, splits, bias, res, out, rows, n);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace hgemm
