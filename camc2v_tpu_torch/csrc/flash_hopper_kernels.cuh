// The kernel bodies of the Hopper attention core (flash_hopper.cuh), templates
// on the mask policy: the forward (K2 under BoolMask, K6 under LineMask, K6p
// under PenaltyMask) and the backward's pre-pass and two sweeps (K5, K7).
// Each kernel file includes this header and instantiates the bodies with its
// policy.
//
// Forward: one block per (128-query tile, head, batch), the heads of a query
// tile adjacent in the grid so they share the policy's tile data and K/V in
// L2. A producer warp issues TMA copies: Q once, then K, V and the policy's
// tile into a two-stage ring guarded by mbarriers (the warp's lanes write the
// policy's plain part of the slot first, `fill`). Two consumer warpgroups own
// 64 query rows each: they scale their Q rows in place to bf16(q * scale),
// then per key tile run S = Q K^T as wgmma from shared memory into
// registers, the mask (where the policy tests the tile's bits), the online
// softmax in registers (quad shuffles), and O += P V with P as the register A
// operand; O stays in registers for the whole key loop and is stored once,
// through shared memory, as 16-byte rows. Two blocks share an SM (94
// registers a thread for D <= 64 under BoolMask): their four consumer
// warpgroups overlap one's softmax with another's products. A pipelined key
// loop (tile j's S issued with tile j - 1's P V) needs more registers than
// that and measured slower on the H100, at one block per SM or spilling at
// two. For the training backward the forward also writes each row's
// logsumexp.
//
// Backward, three kernels on one stream. The pre-pass reads q, out, dout and
// lse once and writes qs = bf16(q * scale), delta = rowsum(dout * out) (f32)
// and lse, the last two padded to whole 128-query tiles (+1e30 past Lq, so
// padded queries give p = 0) so the sweeps can bulk-copy them. Then the two
// sweeps of the JAX grid, each block finishing its own outputs with no
// atomics (dq is bit-stable from run to run): the dq sweep, one block per
// (64-query tile, head, batch) looping over key tiles, and the dk/dv sweep,
// one block per (64-key tile, head, batch) looping over query tiles. Both
// are built as the forward is: a producer warp feeds a two-stage TMA /
// mbarrier ring (the dq sweep streams K, V and the policy's tile; the dk/dv
// sweep qs, dout, lse, delta and the policy's tile), one consumer warpgroup
// runs every product as wgmma with its accumulators in registers (S, dP, dQ;
// S^T, dP^T, dV, dK), P and dS go from accumulator to bf16 A operand in
// registers, and the outputs are stored once through shared memory as
// 16-byte rows. Two blocks share an SM for D <= 64. p = exp(s - lse),
// ds = p (dp - delta), dq = bf16(bf16(ds K) * scale), dk = ds^T qs,
// dv = p^T dout: ds and p rounded to bf16 for the products, every sum in
// f32; a skipped tile has p = 0, so the skips are exact here too.
#pragma once

#include "flash_hopper.cuh"

namespace hflash {
namespace {

// ------------------------------------------------------------ forward

constexpr int FWD_CONSUMERS = 2;                       // warpgroups, 64 query rows each
constexpr int FWD_THREADS = FWD_CONSUMERS * 128 + 32;  // plus the producer warp

template <class Mask>
struct FwdParams {
  Mask mask;
  bf16* out;
  float* lse;  // null: not wanted
  int Lq, Lk, H, D;
  float scale;
};

template <int DP, class Mask>
struct FwdSmem {
  static constexpr int Q = BQ * DP * 2;
  static constexpr int KV = BK * DP * 2;
  static constexpr int M = Mask::stage_size(BQ);
  static constexpr int q_off = 0;
  static constexpr int k_off = Q;
  static constexpr int v_off = k_off + STAGES * KV;
  static constexpr int m_off = v_off + STAGES * KV;
  static constexpr int bar_off = m_off + STAGES * M;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// two blocks per SM where the registers allow it (D <= 64)
template <int DP, class Mask>
__global__ void __launch_bounds__(FWD_THREADS, DP == 64 ? 2 : 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tm,
                 const FwdParams<Mask> p) {
  using L = FwdSmem<DP, Mask>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);  // 1024-aligned for the 128B swizzle
  unsigned char* Qs = smem + L::q_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, qt = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int nk = (p.Lk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], FWD_CONSUMERS * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == FWD_CONSUMERS * 4) {
    // ---------------- producer: the warp fills the slot's plain part, lane 0 issues the copies
    if (lane == 0) {
      mbar_expect_tx(q_full, L::Q);
      tma_tile<DP>(Qs, &tq, q_full, BQ, q0, h, b);
    }
    int it = 0;
    for (int kt = 0; kt < nk; ++kt) {
      if (p.mask.skip(b, qt, kt)) continue;
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      ++it;
      const int j0 = kt * BK;
      uint8_t* ms = smem + L::m_off + s * L::M;
      p.mask.fill(ms, BQ, lane, j0);
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::KV + p.mask.bytes(BQ, j0));
        tma_tile<DP>(smem + L::k_off + s * L::KV, &tk, &full[s], BK, j0, h, b);
        tma_tile<DP>(smem + L::v_off + s * L::KV, &tv, &full[s], BK, j0, h, b);
        p.mask.stage(ms, &tm, &full[s], BQ, b, q0, j0);
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

    // mask (where the policy tests this tile's bits), row max,
    // probabilities, row sums
    if (p.mask.tested(j0, p.Lk)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j < 2 ? r0 : r0 + 8, c = 8 * i + 2 * tq4 + (j & 1);
          if (!p.mask.visible(Ms, r, c, j0, p.Lk)) sc[4 * i + j] = NEG_INF;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      p.mask.score(Ms, r0, 8 * i + 2 * tq4, j0, sc[4 * i], sc[4 * i + 1]);
      p.mask.score(Ms, r0 + 8, 8 * i + 2 * tq4, j0, sc[4 * i + 2], sc[4 * i + 3]);
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < 2) mx0 = fmaxf(mx0, sc[4 * i + j]);
        else mx1 = fmaxf(mx1, sc[4 * i + j]);
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

// the forward over B x ceil(Lq / BQ) query tiles x H heads; tq, tk, tv map
// q, k, v with boxes of BQ, BK and BK rows, tm the policy's tensor map (if any)
template <int DP, class Mask>
int launch_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, const CUtensorMap& tm,
               const FwdParams<Mask>& p, int B, cudaStream_t stream) {
  const int smem = FwdSmem<DP, Mask>::bytes;
  cudaFuncSetAttribute(flash_fwd_kernel<DP, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  RETURN_IF_ERR();
  flash_fwd_kernel<DP, Mask><<<dim3(p.H, (p.Lq + BQ - 1) / BQ, B), FWD_THREADS, smem, stream>>>(tq, tk, tv, tm, p);
  RETURN_IF_ERR();
  return 0;
}

// ------------------------------------------------------------ backward

constexpr int BWD_THREADS = 128 + 32;  // one consumer warpgroup and the producer warp
constexpr int ROWS = 64;               // query rows (dq sweep) or keys (dk/dv sweep) of a block

template <class Mask>
struct BwdParams {
  Mask mask;
  const float* lse;    // (B, H, LqP), +1e30 past Lq
  const float* delta;  // (B, H, LqP), 0 past Lq
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Lq, LqP, Lk, H, D;
  float scale;
};

// one group of `tpr` threads (a power of two >= D / 8) per (b, l, h), l < LqP
__global__ void __launch_bounds__(256)
flash_bwd_prepass(const bf16* __restrict__ q, const bf16* __restrict__ out, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, bf16* __restrict__ qs, float* __restrict__ lse_pad,
                  float* __restrict__ delta_pad, int B, int Lq, int LqP, int H, int D, float scale, int tpr) {
  const long long gid = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / tpr;
  const int sub = threadIdx.x % tpr;
  const bool valid = gid < (long long)B * LqP * H;
  const int h = (int)(gid % H), l = (int)((gid / H) % LqP);
  const long long b = gid / ((long long)H * LqP);
  float acc = 0.f;
  if (valid && l < Lq && sub * 8 < D) {
    const long long o = ((b * Lq + l) * H + h) * D + sub * 8;
    const uint4 qv = *reinterpret_cast<const uint4*>(q + o);
    const uint4 ov = *reinterpret_cast<const uint4*>(out + o);
    const uint4 dv = *reinterpret_cast<const uint4*>(dout + o);
    const __nv_bfloat162* qe = reinterpret_cast<const __nv_bfloat162*>(&qv);
    const __nv_bfloat162* oe = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* de = reinterpret_cast<const __nv_bfloat162*>(&dv);
    uint4 sv;
    __nv_bfloat162* se = reinterpret_cast<__nv_bfloat162*>(&sv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fq = __bfloat1622float2(qe[j]), fo = __bfloat1622float2(oe[j]), fd = __bfloat1622float2(de[j]);
      se[j] = __floats2bfloat162_rn(fq.x * scale, fq.y * scale);
      acc += fd.x * fo.x + fd.y * fo.y;
    }
    *reinterpret_cast<uint4*>(qs + o) = sv;
  }
  for (int off = tpr / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && sub == 0) {
    const long long row = (b * H + h);
    delta_pad[row * LqP + l] = l < Lq ? acc : 0.f;
    lse_pad[row * LqP + l] = l < Lq ? lse[row * Lq + l] : LSE_MASKED;
  }
}

// the pre-pass over q, out, dout (B, Lq, H, D) and lse (B, H, Lq): qs
// (B, Lq, H, D), lse_pad and delta_pad (B, H, LqP)
inline int launch_prepass(const void* q, const void* out, const void* dout, const void* lse, void* qs,
                          void* lse_pad, void* delta_pad, int B, int Lq, int LqP, int H, int D, float scale,
                          cudaStream_t stream) {
  int tpr = 1;
  while (tpr * 8 < D) tpr *= 2;
  const long long threads = (long long)B * LqP * H * tpr;
  flash_bwd_prepass<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      (const bf16*)q, (const bf16*)out, (const bf16*)dout, (const float*)lse, (bf16*)qs, (float*)lse_pad,
      (float*)delta_pad, B, Lq, LqP, H, D, scale, tpr);
  RETURN_IF_ERR();
  return 0;
}

template <int DP, class Mask>
struct DqSmem {
  static constexpr int T = ROWS * DP * 2;  // one 64-row tile
  static constexpr int M = Mask::stage_size(ROWS);
  static constexpr int q_off = 0, do_off = T, k_off = 2 * T;
  static constexpr int v_off = k_off + STAGES * T;
  static constexpr int m_off = v_off + STAGES * T;
  static constexpr int bar_off = m_off + STAGES * M;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, class Mask>
__global__ void __launch_bounds__(BWD_THREADS, DP == 64 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tm, const BwdParams<Mask> p) {
  using L = DqSmem<DP, Mask>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::q_off;
  unsigned char* dOs = smem + L::do_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = blockIdx.y * ROWS, qt = q0 / BQ;  // the tile map's query tile
  const int nk = (p.Lk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * L::T);
      tma_tile<DP>(Qs, &tqs, q_full, ROWS, q0, h, b);
      tma_tile<DP>(dOs, &tdo, q_full, ROWS, q0, h, b);
    }
    int it = 0;
    for (int kt = 0; kt < nk; ++kt) {
      if (p.mask.skip(b, qt, kt)) continue;
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      ++it;
      const int j0 = kt * BK;
      uint8_t* ms = smem + L::m_off + s * L::M;
      p.mask.fill(ms, ROWS, lane, j0);
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * L::T + p.mask.bytes(ROWS, j0));
        tma_tile<DP>(smem + L::k_off + s * L::T, &tk, &full[s], BK, j0, h, b);
        tma_tile<DP>(smem + L::v_off + s * L::T, &tv, &full[s], BK, j0, h, b);
        p.mask.stage(ms, &tm, &full[s], ROWS, b, q0, j0);
      }
    }
    return;
  }

  const int t = threadIdx.x, g = lane / 4, tq4 = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's query rows r0 and r0 + 8 of the block
  const long long srow = ((long long)b * p.H + h) * p.LqP + q0;
  const float ls0 = p.lse[srow + r0] * LOG2E, ls1 = p.lse[srow + r0 + 8] * LOG2E;
  const float dl0 = p.delta[srow + r0], dl1 = p.delta[srow + r0 + 8];

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);

  int it = 0;
  for (int kt = 0; kt < nk; ++kt) {
    if (p.mask.skip(b, qt, kt)) continue;
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    ++it;
    const unsigned char* Ks = smem + L::k_off + s * L::T;
    const unsigned char* Vs = smem + L::v_off + s * L::T;
    const uint8_t* Ms = smem + L::m_off + s * L::M;
    const int j0 = kt * BK;

    // S = Qs K^T, dP = dO V^T
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<0>(sc, desc_k(Qs, ROWS, 0, kk), desc_k(Ks, BK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<0>(dp, desc_k(dOs, ROWS, 0, kk), desc_k(Vs, BK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // ds = p (dp - delta), p = exp(s - lse); invisible pairs (where the
    // policy tests this tile's bits) get the logit -1e30, so p = 0
    if (p.mask.tested(j0, p.Lk)) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = j < 2 ? r0 : r0 + 8, c = 8 * i + 2 * tq4 + (j & 1);
          if (!p.mask.visible(Ms, r, c, j0, p.Lk)) sc[4 * i + j] = NEG_INF;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = ex2(fmaf(sc[4 * i + j], LOG2E, j < 2 ? -ls0 : -ls1));
        sc[4 * i + j] = pr * (dp[4 * i + j] - (j < 2 ? dl0 : dl1));
      }
    }

    // dQ += dS K, dS in bf16 registers, K MN-major
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_fragment(sc, kk, da[kk]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<1>(dq, da[kk], desc_mn(Ks, BK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[s]);
  }

  // dq = bf16(bf16(dS K) * scale), through the Qs tile, then 16-byte stores
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * tq4;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(__float2bfloat16(dq[4 * i + j])) * p.scale;
    *reinterpret_cast<uint32_t*>(Qs + tile_offset(ROWS, r0, c)) = pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(Qs + tile_offset(ROWS, r0 + 8, c)) = pack_bf16(v[2], v[3]);
  }
  named_barrier(1, 128);
  const int chunks = p.D / 8;
  for (int i = t; i < ROWS * chunks; i += 128) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (q0 + r < p.Lq)
      *reinterpret_cast<uint4*>(p.dq + (((long long)b * p.Lq + q0 + r) * p.H + h) * p.D + c) =
          *reinterpret_cast<const uint4*>(Qs + tile_offset(ROWS, r, c));
  }
}

// queries per streamed tile: 64, or 32 where D > 64 keeps dK and dV (64 f32
// registers each) beside the score tiles without spilling
template <int DP, class Mask>
struct DkvSmem {
  static constexpr int NQS = DP == 64 ? 64 : 32;
  static constexpr int KT = ROWS * DP * 2;  // the block's K or V tile
  static constexpr int QT = NQS * DP * 2;   // a streamed qs or dout tile
  static constexpr int M = Mask::stage_size(NQS);
  static constexpr int k_off = 0, v_off = KT;
  static constexpr int q_off = 2 * KT;
  static constexpr int do_off = q_off + STAGES * QT;
  static constexpr int m_off = do_off + STAGES * QT;
  static constexpr int lse_off = m_off + STAGES * M;
  static constexpr int dl_off = lse_off + STAGES * NQS * 4;
  static constexpr int bar_off = dl_off + STAGES * NQS * 4;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP, class Mask>
__global__ void __launch_bounds__(BWD_THREADS, DP == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tm, const BwdParams<Mask> p) {
  using L = DkvSmem<DP, Mask>;
  constexpr int NQS = L::NQS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem + L::k_off;
  unsigned char* Vs = smem + L::v_off;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;
  const int j0 = kt * BK;
  const int nq = p.LqP / BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const long long srow = ((long long)b * p.H + h) * p.LqP;
  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * L::KT);
      tma_tile<DP>(Ks, &tk, kv_full, ROWS, j0, h, b);
      tma_tile<DP>(Vs, &tv, kv_full, ROWS, j0, h, b);
    }
    int it = 0;
    for (int qt = 0; qt < nq; ++qt) {
      if (p.mask.skip(b, qt, kt)) continue;
      for (int q0 = qt * BQ; q0 < qt * BQ + BQ && q0 < p.Lq; q0 += NQS) {
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        ++it;
        uint8_t* ms = smem + L::m_off + s * L::M;
        p.mask.fill(ms, NQS, lane, j0);
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::QT + 2 * NQS * 4 + p.mask.bytes(NQS, j0));
          tma_tile<DP>(smem + L::q_off + s * L::QT, &tqs, &full[s], NQS, q0, h, b);
          tma_tile<DP>(smem + L::do_off + s * L::QT, &tdo, &full[s], NQS, q0, h, b);
          bulk_load(smem + L::lse_off + s * NQS * 4, p.lse + srow + q0, NQS * 4, &full[s]);
          bulk_load(smem + L::dl_off + s * NQS * 4, p.delta + srow + q0, NQS * 4, &full[s]);
          p.mask.stage(ms, &tm, &full[s], NQS, b, q0, j0);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x, g = lane / 4, tq4 = lane % 4;
  const int k0 = warp * 16 + g;  // this thread's keys k0 and k0 + 8 of the block (accumulator rows)
  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);

  int it = 0;
  for (int qt = 0; qt < nq; ++qt) {
    if (p.mask.skip(b, qt, kt)) continue;
    for (int q0 = qt * BQ; q0 < qt * BQ + BQ && q0 < p.Lq; q0 += NQS) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      ++it;
      const unsigned char* Qs = smem + L::q_off + s * L::QT;
      const unsigned char* dOs = smem + L::do_off + s * L::QT;
      const uint8_t* Ms = smem + L::m_off + s * L::M;
      const float* lse_s = reinterpret_cast<const float*>(smem + L::lse_off + s * NQS * 4);
      const float* dl_s = reinterpret_cast<const float*>(smem + L::dl_off + s * NQS * 4);

      // S^T = K Qs^T, dP^T = V dO^T (64 keys x NQS queries)
      float st[NQS / 2], dpt[NQS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<0>(st, desc_k(Ks, ROWS, 0, kk), desc_k(Qs, NQS, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) wgmma_ss<0>(dpt, desc_k(Vs, ROWS, 0, kk), desc_k(dOs, NQS, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // p and ds per (key, query); padded queries carry lse +1e30 (p = 0),
      // keys past Lk only feed rows that are never stored; invisible pairs
      // (where the policy tests this tile's bits) get the logit -1e30, so p = 0
      if (p.mask.tested(j0, p.Lk)) {
#pragma unroll
        for (int i = 0; i < NQS / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (!p.mask.visible(Ms, 8 * i + 2 * tq4 + (j & 1), j < 2 ? k0 : k0 + 8, j0, p.Lk))
              st[4 * i + j] = NEG_INF;
        }
      }
#pragma unroll
      for (int i = 0; i < NQS / 8; ++i) {
        const int c = 8 * i + 2 * tq4;
        const float2 lc = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dc = *reinterpret_cast<const float2*>(dl_s + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float pr = ex2(fmaf(st[4 * i + j], LOG2E, -(j & 1 ? lc.y : lc.x) * LOG2E));
          st[4 * i + j] = pr;
          dpt[4 * i + j] = pr * (dpt[4 * i + j] - (j & 1 ? dc.y : dc.x));
        }
      }

      // dV += P^T dO, dK += dS^T Qs; P^T, dS^T in bf16 registers, dO and Qs MN-major
      uint32_t pa[NQS / 16][4], da[NQS / 16][4];
#pragma unroll
      for (int kk = 0; kk < NQS / 16; ++kk) {
        a_fragment(st, kk, pa[kk]);
        a_fragment(dpt, kk, da[kk]);
      }
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NQS / 16; ++kk) wgmma_rs<1>(dv, pa[kk], desc_mn(dOs, NQS, kk), 1);
#pragma unroll
      for (int kk = 0; kk < NQS / 16; ++kk) wgmma_rs<1>(dk, da[kk], desc_mn(Qs, NQS, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[s]);
    }
  }

  // dk, dv as bf16 through the K and V tiles, then 16-byte stores
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * tq4;
    *reinterpret_cast<uint32_t*>(Ks + tile_offset(ROWS, k0, c)) = pack_bf16(dk[4 * i], dk[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(Ks + tile_offset(ROWS, k0 + 8, c)) = pack_bf16(dk[4 * i + 2], dk[4 * i + 3]);
    *reinterpret_cast<uint32_t*>(Vs + tile_offset(ROWS, k0, c)) = pack_bf16(dv[4 * i], dv[4 * i + 1]);
    *reinterpret_cast<uint32_t*>(Vs + tile_offset(ROWS, k0 + 8, c)) = pack_bf16(dv[4 * i + 2], dv[4 * i + 3]);
  }
  named_barrier(1, 128);
  const int chunks = p.D / 8;
  for (int i = t; i < ROWS * chunks; i += 128) {
    const int r = i / chunks, c = (i % chunks) * 8;
    if (j0 + r < p.Lk) {
      const long long o = (((long long)b * p.Lk + j0 + r) * p.H + h) * p.D + c;
      *reinterpret_cast<uint4*>(p.dk + o) = *reinterpret_cast<const uint4*>(Ks + tile_offset(ROWS, r, c));
      *reinterpret_cast<uint4*>(p.dv + o) = *reinterpret_cast<const uint4*>(Vs + tile_offset(ROWS, r, c));
    }
  }
}

// the two sweeps over qs, dout (B, Lq, H, D) and k, v (B, Lk, H, D); tm and
// tm2 are the policy's tensor maps (if any) with boxes of ROWS and NQS query
// rows
template <int DP, class Mask>
int launch_sweeps(const void* qs, const void* k, const void* v, const void* dout, const CUtensorMap& tm,
                  const CUtensorMap& tm2, int B, const BwdParams<Mask>& p, cudaStream_t stream) {
  constexpr int NQS = DkvSmem<DP, Mask>::NQS;
  const int Lq = p.Lq, Lk = p.Lk, H = p.H, D = p.D;
  CUtensorMap tqs, tdo, tk, tv, tqs2, tdo2;
  if (!bf16_map(&tqs, qs, B, Lq, H, D, ROWS) || !bf16_map(&tdo, dout, B, Lq, H, D, ROWS) ||
      !bf16_map(&tk, k, B, Lk, H, D, ROWS) || !bf16_map(&tv, v, B, Lk, H, D, ROWS) ||
      !bf16_map(&tqs2, qs, B, Lq, H, D, NQS) || !bf16_map(&tdo2, dout, B, Lq, H, D, NQS))
    return (int)cudaErrorInvalidValue;
  const int smem_dq = DqSmem<DP, Mask>::bytes, smem_dkv = DkvSmem<DP, Mask>::bytes;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP, Mask>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  RETURN_IF_ERR();
  flash_bwd_dq_kernel<DP, Mask><<<dim3(H, (Lq + ROWS - 1) / ROWS, B), BWD_THREADS, smem_dq, stream>>>(
      tqs, tdo, tk, tv, tm, p);
  RETURN_IF_ERR();
  flash_bwd_dkv_kernel<DP, Mask><<<dim3(H, (Lk + BK - 1) / BK, B), BWD_THREADS, smem_dkv, stream>>>(
      tqs2, tdo2, tk, tv, tm2, p);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace
}  // namespace hflash
