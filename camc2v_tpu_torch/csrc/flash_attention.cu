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
// keys (77 text tokens). The design, FA3's: one block per (128-query tile,
// head, batch), the heads of a query tile adjacent in the grid so they share
// the mask tile and K/V in L2. A producer warp issues TMA copies: Q once,
// then K, V and the mask tile into a two-stage ring guarded by mbarriers.
// Two consumer warpgroups own 64 query rows each: they scale their Q rows
// in place to bf16(q * scale), then per key tile run S = Q K^T as wgmma from
// shared memory into registers, the online softmax in registers (quad
// shuffles), and O += P V with P as the register A operand; O stays in
// registers for the whole key loop and is stored once, through shared
// memory, as 16-byte rows. Two blocks share an SM (94 registers a thread
// for D <= 64, under the 96 that two 288-thread blocks leave): their four
// consumer warpgroups overlap one's softmax with another's products. A
// pipelined key loop (tile j's S issued with tile j - 1's P V) needs more
// registers than that and measured slower on the H100, at one block per SM
// or spilling at two.
#include "flash_hopper.cuh"

namespace {

using namespace hflash;

constexpr int CONSUMERS = 2;                      // warpgroups, 64 query rows each
constexpr int THREADS = CONSUMERS * 128 + 32;     // plus the producer warp

struct FwdParams {
  BoolMask mask;
  bf16* out;
  float* lse;  // null: not wanted
  int Lq, Lk, H, D;
  float scale;
};

template <int DP>
struct FwdSmem {
  static constexpr int Q = BQ * DP * 2;
  static constexpr int KV = BK * DP * 2;
  static constexpr int M = BQ * BK;
  static constexpr int q_off = 0;
  static constexpr int k_off = Q;
  static constexpr int v_off = k_off + STAGES * KV;
  static constexpr int m_off = v_off + STAGES * KV;
  static constexpr int bar_off = m_off + STAGES * M;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// two blocks per SM where the registers allow it (D <= 64)
template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tm, const FwdParams p) {
  using L = FwdSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned for the 128B swizzle
  unsigned char* Qs = smem + L::q_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int nk = p.mask.nk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---------------- producer
    if (lane == 0) {
      mbar_expect_tx(q_full, L::Q);
      tma_tile<DP>(Qs, &tq, q_full, BQ, q0, h, b);
      int it = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (p.mask.skip(b, qt, kt)) continue;
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        ++it;
        const int j0 = kt * BK;
        mbar_expect_tx(&full[s], 2 * L::KV + (p.mask.on ? L::M : 0));
        tma_tile<DP>(smem + L::k_off + s * L::KV, &tk, &full[s], BK, j0, h, b);
        tma_tile<DP>(smem + L::v_off + s * L::KV, &tv, &full[s], BK, j0, h, b);
        p.mask.stage(smem + L::m_off + s * L::M, &tm, &full[s], BQ, b, q0, j0);
      }
    }
    return;
  }

  // ---------------- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4, t = threadIdx.x % 128;
  const int g = lane / 4, tq4 = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows r0 and r0 + 8 of the tile

  // Q arrives raw; scale this warpgroup's rows in place: bf16(q * scale)
  mbar_wait(q_full, 0);
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) {
    uint4* rows = reinterpret_cast<uint4*>(Qs + a * BQ * 128 + wg * 64 * 128);
    for (int i = t; i < 64 * 8; i += 128) {
      uint4 v = rows[i];
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(e[j]);
        e[j] = __floats2bfloat162_rn(f.x * p.scale, f.y * p.scale);
      }
      rows[i] = v;
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m0 = M_FLOOR, m1 = M_FLOOR, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sums

  int it = 0;
  for (int kt = 0; kt < nk; ++kt) {
    if (p.mask.skip(b, qt, kt)) continue;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    ++it;
    const unsigned char* Ks = smem + L::k_off + s * L::KV;
    const unsigned char* Vs = smem + L::v_off + s * L::KV;
    const uint8_t* Ms = smem + L::m_off + s * L::M;
    const int j0 = kt * BK;

    // S = Q K^T (64 x 64 per warpgroup), over all DP columns (those past D
    // are zero in both tiles)
    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss<0>(sc, desc_k(Qs, BQ, wg * 64, kk), desc_k(Ks, BK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask (only where a mask is given or the tile passes Lk), row max,
    // probabilities, row sums
    if (p.mask.on || j0 + BK > p.Lk) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j < 2 ? r0 : r0 + 8, c = 8 * i + 2 * tq4 + (j & 1);
          if (!(p.mask.on ? p.mask.visible(Ms, r, c) : j0 + c < p.Lk)) sc[4 * i + j] = NEG_INF;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = p.mask.score(j < 2 ? r0 : r0 + 8, 8 * i + 2 * tq4 + (j & 1), sc[4 * i + j]);
        sc[4 * i + j] = v;
        if (j < 2) mx0 = fmaxf(mx0, v);
        else mx1 = fmaxf(mx1, v);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(fmaxf(m0, mx0), M_FLOOR), n1 = fmaxf(fmaxf(m1, mx1), M_FLOOR);
    const float ns0 = n0 * LOG2E, ns1 = n1 * LOG2E;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      sc[4 * i + 0] = ex2(fmaf(sc[4 * i + 0], LOG2E, -ns0));
      sc[4 * i + 1] = ex2(fmaf(sc[4 * i + 1], LOG2E, -ns0));
      sc[4 * i + 2] = ex2(fmaf(sc[4 * i + 2], LOG2E, -ns1));
      sc[4 * i + 3] = ex2(fmaf(sc[4 * i + 3], LOG2E, -ns1));
      sum0 += sc[4 * i + 0] + sc[4 * i + 1];
      sum1 += sc[4 * i + 2] + sc[4 * i + 3];
    }
    const float al0 = ex2((m0 - n0) * LOG2E), al1 = ex2((m1 - n1) * LOG2E);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      o[4 * i + 0] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }

    // O += P V, P in bf16 registers, V MN-major
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragment(sc, kk, pa[kk]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(o, pa[kk], desc_mn(Vs, BK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[s]);
  }

  // ---------------- epilogue: O / l as bf16 through this warpgroup's Q rows, then 16-byte stores
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = l0 == 0.f ? 1.f : l0, d1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * tq4;
    *reinterpret_cast<uint32_t*>(Qs + tile_offset(BQ, r0, c)) = pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
    *reinterpret_cast<uint32_t*>(Qs + tile_offset(BQ, r0 + 8, c)) =
        pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
  }
  if (p.lse != nullptr && tq4 == 0) {
    const long long base = ((long long)b * p.H + h) * p.Lq;
    if (q0 + r0 < p.Lq) p.lse[base + q0 + r0] = l0 == 0.f ? LSE_MASKED : m0 + logf(l0);
    if (q0 + r0 + 8 < p.Lq) p.lse[base + q0 + r0 + 8] = l1 == 0.f ? LSE_MASKED : m1 + logf(l1);
  }
  named_barrier(1 + wg, 128);
  const int chunks = p.D / 8;
  for (int i = t; i < 64 * chunks; i += 128) {
    const int r = wg * 64 + i / chunks, c = (i % chunks) * 8;
    if (q0 + r < p.Lq)
      *reinterpret_cast<uint4*>(p.out + (((long long)b * p.Lq + q0 + r) * p.H + h) * p.D + c) =
          *reinterpret_cast<const uint4*>(Qs + tile_offset(BQ, r, c));
  }
}

template <int DP>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tm,
           const FwdParams& p, int B, int nq, cudaStream_t stream) {
  const int smem = FwdSmem<DP>::bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  RETURN_IF_ERR();
  flash_fwd_kernel<DP><<<dim3(p.H, nq, B), THREADS, smem, stream>>>(tq, tk, tv, tm, p);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

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
  FwdParams p{BoolMask{(const uint8_t*)tile_any, nq, nk, mask != nullptr, mask_bstride == 0},
              (bf16*)out, (float*)lse, Lq, Lk, H, D, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return padded_d(D) == 64 ? launch<64>(tq, tk, tv, tm, p, B, nq, s) : launch<128>(tq, tk, tv, tm, p, B, nq, s);
}
