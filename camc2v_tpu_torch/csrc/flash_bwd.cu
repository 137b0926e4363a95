// K5: flash attention backward (dq; dk and dv) over (B, L, H, D) bf16.
//
// Replaces the Pallas kernels camc2v_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and _bwd_dkv_kernel (entry _flash_bwd_impl, the custom VJP
// of flash_attention). Given q, k, v, the optional head-shared bool mask and
// its tile map, K2's output and logsumexp, and dout, it computes
// dq = scale * sum_k ds k, dk = sum_q ds qs, dv = sum_q p dout with
// qs = bf16(q * scale), p = exp(qs k - lse), ds = p (dout v - delta),
// delta = rowsum(dout * out) in f32: ds and p rounded to bf16 for the
// products, every sum in f32, dq rounded as bf16(bf16(ds k) * scale), empty
// mask tiles skipped (exact: p = 0 there), keys past Lk masked, and a fully
// masked row (lse = +1e30) contributes nothing.
//
// Three kernels on one stream. The pre-pass reads q, out, dout and lse once
// and writes qs, delta and lse, the last two padded to whole 128-query tiles
// (+1e30 past Lq, so padded queries give p = 0) so the sweeps can bulk-copy
// them. Then the two sweeps of the JAX grid, each block finishing its own
// outputs with no atomics (dq is bit-stable from run to run): the dq sweep,
// one block per (64-query tile, head, batch) looping over key tiles, and the
// dk/dv sweep, one block per (64-key tile, head, batch) looping over query
// tiles. On the H100 the op is tensor-core bound at the UNet's spatial
// self-attention (Lq = Lk = 1024; 14 D operations per pair with the scores
// recomputed in both sweeps) and latency bound at the short cross-attention
// keys. Both sweeps are built as K2 is (flash_hopper.cuh): a producer warp
// feeds a two-stage TMA / mbarrier ring (the dq sweep streams K, V and the
// mask tile; the dk/dv sweep qs, dout, lse, delta and the mask tile), one
// consumer warpgroup runs every product as wgmma with its accumulators in
// registers (S, dP, dQ; S^T, dP^T, dV, dK), P and dS go from accumulator to
// bf16 A operand in registers, and the outputs are stored once through
// shared memory as 16-byte rows. Two blocks share an SM.
#include "flash_hopper.cuh"

namespace {

using namespace hflash;

constexpr int THREADS = 128 + 32;  // one consumer warpgroup and the producer warp
constexpr int ROWS = 64;           // query rows (dq sweep) or keys (dk/dv sweep) of a block

struct BwdParams {
  BoolMask mask;
  const float* lse;    // (B, H, LqP), +1e30 past Lq
  const float* delta;  // (B, H, LqP), 0 past Lq
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int Lq, LqP, Lk, H, D;
  float scale;
};

// ------------------------------------------------------------ pre-pass

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

// ------------------------------------------------------------ dq sweep

template <int DP>
struct DqSmem {
  static constexpr int T = ROWS * DP * 2;  // one 64-row tile
  static constexpr int M = ROWS * BK;
  static constexpr int q_off = 0, do_off = T, k_off = 2 * T;
  static constexpr int v_off = k_off + STAGES * T;
  static constexpr int m_off = v_off + STAGES * T;
  static constexpr int bar_off = m_off + STAGES * M;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tm, const BwdParams p) {
  using L = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem + L::q_off;
  unsigned char* dOs = smem + L::do_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = blockIdx.y * ROWS, qt = q0 / BQ;  // the tile map's query tile
  const int nk = p.mask.nk;
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
      int it = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (p.mask.skip(b, qt, kt)) continue;
        const int s = it % STAGES;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        ++it;
        const int j0 = kt * BK;
        mbar_expect_tx(&full[s], 2 * L::T + (p.mask.on ? L::M : 0));
        tma_tile<DP>(smem + L::k_off + s * L::T, &tk, &full[s], BK, j0, h, b);
        tma_tile<DP>(smem + L::v_off + s * L::T, &tv, &full[s], BK, j0, h, b);
        p.mask.stage(smem + L::m_off + s * L::M, &tm, &full[s], ROWS, b, q0, j0);
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

    // ds = p (dp - delta), p = exp(s - lse); invisible pairs (only where a
    // mask is given or the tile passes Lk) get the logit -1e30, so p = 0
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
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = j < 2 ? r0 : r0 + 8, c = 8 * i + 2 * tq4 + (j & 1);
        const float pr = ex2(fmaf(p.mask.score(r, c, sc[4 * i + j]), LOG2E, j < 2 ? -ls0 : -ls1));
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

// ------------------------------------------------------------ dk/dv sweep

// queries per streamed tile: 64, or 32 where D > 64 keeps dK and dV (64 f32
// registers each) beside the score tiles without spilling
template <int DP>
struct DkvSmem {
  static constexpr int NQS = DP == 64 ? 64 : 32;
  static constexpr int KT = ROWS * DP * 2;  // the block's K or V tile
  static constexpr int QT = NQS * DP * 2;   // a streamed qs or dout tile
  static constexpr int M = NQS * BK;
  static constexpr int k_off = 0, v_off = KT;
  static constexpr int q_off = 2 * KT;
  static constexpr int do_off = q_off + STAGES * QT;
  static constexpr int m_off = do_off + STAGES * QT;
  static constexpr int lse_off = m_off + STAGES * M;
  static constexpr int dl_off = lse_off + STAGES * NQS * 4;
  static constexpr int bar_off = dl_off + STAGES * NQS * 4;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(THREADS, DP == 64 ? 2 : 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tqs, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tm, const BwdParams p) {
  using L = DkvSmem<DP>;
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
  const int nq = p.mask.nq;
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
      int it = 0;
      for (int qt = 0; qt < nq; ++qt) {
        if (p.mask.skip(b, qt, kt)) continue;
        for (int q0 = qt * BQ; q0 < qt * BQ + BQ && q0 < p.Lq; q0 += NQS) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          ++it;
          mbar_expect_tx(&full[s], 2 * L::QT + 2 * NQS * 4 + (p.mask.on ? L::M : 0));
          tma_tile<DP>(smem + L::q_off + s * L::QT, &tqs, &full[s], NQS, q0, h, b);
          tma_tile<DP>(smem + L::do_off + s * L::QT, &tdo, &full[s], NQS, q0, h, b);
          bulk_load(smem + L::lse_off + s * NQS * 4, p.lse + srow + q0, NQS * 4, &full[s]);
          bulk_load(smem + L::dl_off + s * NQS * 4, p.delta + srow + q0, NQS * 4, &full[s]);
          p.mask.stage(smem + L::m_off + s * L::M, &tm, &full[s], NQS, b, q0, j0);
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
      // (only where a mask is given) get the logit -1e30, so p = 0
      if (p.mask.on) {
#pragma unroll
        for (int i = 0; i < NQS / 8; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (!p.mask.visible(Ms, 8 * i + 2 * tq4 + (j & 1), j < 2 ? k0 : k0 + 8)) st[4 * i + j] = NEG_INF;
        }
      }
#pragma unroll
      for (int i = 0; i < NQS / 8; ++i) {
        const int c = 8 * i + 2 * tq4;
        const float2 lc = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 dc = *reinterpret_cast<const float2*>(dl_s + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kr = j < 2 ? k0 : k0 + 8, qc = c + (j & 1);
          const float pr = ex2(fmaf(p.mask.score(qc, kr, st[4 * i + j]), LOG2E, -(j & 1 ? lc.y : lc.x) * LOG2E));
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

template <int DP>
int launch_sweeps(const void* qs, const void* k, const void* v, const void* dout, const void* mask, int B, int Lq,
                  int Lk, int H, int D, long long mask_bstride, const BwdParams& p, cudaStream_t stream) {
  constexpr int NQS = DkvSmem<DP>::NQS;
  const int nq = p.mask.nq, nk = p.mask.nk, Bm = mask_bstride == 0 ? 1 : B;
  CUtensorMap tqs, tdo, tk, tv, tm = {}, tqs2, tdo2, tm2 = {};
  if (!bf16_map(&tqs, qs, B, Lq, H, D, ROWS) || !bf16_map(&tdo, dout, B, Lq, H, D, ROWS) ||
      !bf16_map(&tk, k, B, Lk, H, D, ROWS) || !bf16_map(&tv, v, B, Lk, H, D, ROWS) ||
      !bf16_map(&tqs2, qs, B, Lq, H, D, NQS) || !bf16_map(&tdo2, dout, B, Lq, H, D, NQS))
    return (int)cudaErrorInvalidValue;
  if (mask != nullptr && (!mask_map(&tm, mask, Bm, nq * BQ, nk * BK, ROWS) ||
                          !mask_map(&tm2, mask, Bm, nq * BQ, nk * BK, NQS)))
    return (int)cudaErrorInvalidValue;
  const int smem_dq = DqSmem<DP>::bytes, smem_dkv = DkvSmem<DP>::bytes;
  cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  RETURN_IF_ERR();
  flash_bwd_dq_kernel<DP><<<dim3(H, (Lq + ROWS - 1) / ROWS, B), THREADS, smem_dq, stream>>>(tqs, tdo, tk, tv, tm, p);
  RETURN_IF_ERR();
  flash_bwd_dkv_kernel<DP><<<dim3(H, nk, B), THREADS, smem_dkv, stream>>>(tqs2, tdo2, tk, tv, tm2, p);
  RETURN_IF_ERR();
  return 0;
}

}  // namespace

// q, out, dout (B, Lq, H, D), k/v (B, Lk, H, D): contiguous bf16, 16-byte
// aligned; lse (B, H, Lq) f32 from K2; mask and tile_any as for flash_fwd
// (the padded uint8 mask over 128 x 64 tiles); `scale` the bf16-rounded
// softmax scale. Scratch from the caller: qs (B, Lq, H, D) bf16, lse_pad
// and delta_pad (B, H, LqP) f32 with LqP = 128 * ceil(Lq / 128). Writes dq
// (B, Lq, H, D), dk and dv (B, Lk, H, D) bf16.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out, const void* dout,
                         const void* lse, const void* mask, const void* tile_any, void* qs, void* lse_pad,
                         void* delta_pad, void* dq, void* dk, void* dv, int B, int Lq, int Lk, int H, int D,
                         float scale, long long mask_bstride, void* stream) {
  if (D % 16 != 0 || D > 128 || D <= 0) return (int)cudaErrorInvalidValue;
  const int nq = (Lq + BQ - 1) / BQ, nk = (Lk + BK - 1) / BK, LqP = nq * BQ;
  cudaStream_t s = (cudaStream_t)stream;
  int tpr = 1;
  while (tpr * 8 < D) tpr *= 2;
  const long long threads = (long long)B * LqP * H * tpr;
  flash_bwd_prepass<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      (const bf16*)q, (const bf16*)out, (const bf16*)dout, (const float*)lse, (bf16*)qs, (float*)lse_pad,
      (float*)delta_pad, B, Lq, LqP, H, D, scale, tpr);
  RETURN_IF_ERR();
  BwdParams p{BoolMask{(const uint8_t*)tile_any, nq, nk, mask != nullptr, mask_bstride == 0},
              (const float*)lse_pad, (const float*)delta_pad, (bf16*)dq, (bf16*)dk, (bf16*)dv,
              Lq, LqP, Lk, H, D, scale};
  return padded_d(D) == 64 ? launch_sweeps<64>(qs, k, v, dout, mask, B, Lq, Lk, H, D, mask_bstride, p, s)
                           : launch_sweeps<128>(qs, k, v, dout, mask, B, Lq, Lk, H, D, mask_bstride, p, s);
}
