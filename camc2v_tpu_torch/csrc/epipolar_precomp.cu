// K6p: epipolar flash attention forward with the mask read from precomputed
// bf16 additive penalty tiles, over (B, L, H, D) bf16.
//
// Replaces the Pallas kernel camc2v_tpu/ops/epipolar_flash.py::_v2p_kernel
// (entry epipolar_flash_attention with `penalties`): K6's online softmax and
// hull-map subtile skips, with each frame key's logit raised by its penalty
// (0 visible, -1e30 hidden) streamed from a (pb, Lq, t*hw) array built once
// per request (materialize_penalties) instead of the line distance computed
// in the kernel. The penalties cover the frame keys only: the register keys
// after them stay always visible, as in K6, and the keys are not padded.
// Batch b reads penalty batch b % pb, so the fused-CFG batch of 2B
// (cond and uncond share one camera geometry) streams one copy.
//
// The op is bound by bytes: at ds8 the penalties of the subtiles the skip
// map leaves on outweigh q, k and v. A block owns one 64-query tile of one
// head, and the heads of a query tile are neighbouring blocks in launch
// order (block x = query tile * H + head), so each penalty tile comes from
// device memory about once and from L2 for the other heads.
#include "flash_core.cuh"

namespace {

constexpr int LDPEN = flash::BK + 8;  // staged penalty tile, bf16

struct PenMask {
  const bf16* pen;       // (pb, Lq, thw)
  const int* tile_any;   // (B, Lq / block_q, cols)
  int Lq, thw, nreg, pb, block_q, sub, cols, nqb;
  bf16* tile;            // this 64x64 tile's penalties

  __device__ bool skip(int b, int qt, int kt) const {
    const int row = qt * flash::BQ / block_q;
    const int col = kt * flash::BK / sub;
    return !tile_any[((long long)b * nqb + row) * cols + col];
  }

  __device__ void stage(int b, int q0, int j0) const {
    if (j0 >= thw) return;  // register tile: no penalties
    const bf16* src = pen + ((long long)(b % pb) * Lq + q0) * thw + j0;
    constexpr int chunks = flash::BK / 8;  // 16-byte pieces of a row
    for (int i = threadIdx.x; i < flash::BQ * chunks; i += blockDim.x) {
      const int r = i / chunks, c8 = i % chunks;
      *reinterpret_cast<uint4*>(tile + r * LDPEN + c8 * 8) =
          *reinterpret_cast<const uint4*>(src + (long long)r * thw + c8 * 8);
    }
  }

  __device__ bool visible(int, int, int, int kj) const { return kj < thw || kj - thw < nreg; }

  __device__ float score(int rb, int kj, float s) const {
    return kj < thw ? s + __bfloat162float(tile[rb * LDPEN + (kj & (flash::BK - 1))]) : s;
  }
};

__global__ void __launch_bounds__(flash::WARPS * 32)
epipolar_precomp_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                        const bf16* __restrict__ pen, const int* __restrict__ tile_any, bf16* __restrict__ out,
                        int Lq, int Lk, int H, int D, int thw, int nreg, int pb, int block_q, int sub, int cols,
                        float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* tile = reinterpret_cast<bf16*>(smem + flash::core_smem_bytes(D));
  PenMask m{pen, tile_any, Lq, thw, nreg, pb, block_q, sub, cols, Lq / block_q, tile};
  const int lk_valid = thw + nreg;
  const int nk = (lk_valid + flash::BK - 1) / flash::BK;
  flash::attention_body(q, k, v, out, Lq, Lk, lk_valid, H, D, scale, nk, smem, m, blockIdx.x / H,
                        blockIdx.x % H, blockIdx.y);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk = thw + nreg, H, D), out (B, Lq, H, D):
// contiguous bf16. pen (pb, Lq, thw) contiguous bf16 with B % pb == 0;
// tile_any (B, Lq / block_q, cols) int32 as for K6 (cols = (thw + block_k) /
// sub, the register column at thw / sub). thw and sub multiples of 64,
// block_q a multiple of 64, nreg <= 64, D a multiple of 16 up to 128 (the
// wrapper checks). `scale` is the bf16-rounded softmax scale.
extern "C" int epipolar_precomp_fwd(const void* q, const void* k, const void* v, const void* pen,
                                    const void* tile_any, void* out, int B, int Lq, int Lk, int H, int D, int thw,
                                    int nreg, int pb, int block_q, int sub, int cols, float scale, void* stream) {
  if (D % 16 != 0 || D > 128 || thw % flash::BK != 0 || sub % flash::BK != 0 || block_q % flash::BQ != 0 ||
      Lq % block_q != 0 || nreg < 0 || nreg > flash::BK || Lk != thw + nreg || pb < 1 || B % pb != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = flash::core_smem_bytes(D) + (size_t)flash::BQ * LDPEN * sizeof(bf16);
  cudaFuncSetAttribute(epipolar_precomp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RETURN_IF_ERR();
  dim3 grid((Lq / flash::BQ) * H, B);
  epipolar_precomp_kernel<<<grid, flash::WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)pen, (const int*)tile_any, (bf16*)out, Lq, Lk,
      H, D, thw, nreg, pb, block_q, sub, cols, scale);
  RETURN_IF_ERR();
  return 0;
}
