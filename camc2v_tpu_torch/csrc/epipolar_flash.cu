// K6: epipolar flash attention forward, the mask recomputed from epipolar
// lines inside the kernel, over (B, L, H, D) bf16.
//
// Replaces the Pallas kernel camc2v_tpu/ops/epipolar_flash.py::_v2_kernel
// (entry epipolar_flash_attention, in-kernel mask path). What it computes:
// attention of q (B, Lq, H, D) over k/v (B, t*hw + nreg, H, D) where the
// key j < t*hw of frame f = j / hw is visible to query i when
// |a*px + b*py + c| < ds*sqrt(2)/2, (a, b, c) = lines[b, i, f] (f32) and
// (px, py) the image coordinates of pixel j % hw; the `nreg` keys after the
// frames (register tokens) are always visible. The distance is formed as
// __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c), the order the
// plain twin uses in eager torch, so no FMA contraction flips a borderline
// bit; NaN lines (F == 0) compare false and hide their whole frame.
//
// Skipping: `tile_any` (B, Lq/block_q, cols) marks the SUBTILE-wide key
// ranges that can be visible to a block_q-query tile (hull bound, exactly
// safe). A 64-query tile reads the bit of its enclosing block_q tile (a
// superset) for the subtile j0 / sub that holds its 64-key tile; skipped
// tiles load nothing. Each key picks its line by its own frame (j / hw), so
// the ds16 layout, where one canonical key tile spans four frames, needs no
// special case.
//
// The TPU kernel's 256 x 1024 tiles, whole-key-axis VMEM residency and head
// groups do not carry over: this is the online-softmax core of K2
// (flash_core.cuh) with a line-distance mask policy. The masks are sparse
// (a few percent of the bits set), so the op's least time is set by its
// bytes; the 256 x 256 skip map leaves far more pairs on than the mask
// keeps, and the core's WMMA tiles with scores in shared memory reach a
// fraction of the bf16 peak. A finer skip map and wgmma/TMA are later work.
#include "flash_core.cuh"

namespace {

// floats of the policy's staging area: 64 query lines (a, b, c), then the
// 64 keys' x and y image coordinates
constexpr int STAGE_FLOATS = flash::BQ * 3 + 2 * flash::BK;

struct LineMask {
  const float* lines;    // (B, Lq, t, 3)
  const int* tile_any;   // (B, Lq / block_q, cols)
  int Lq, t, thw, hw, w, nreg, block_q, sub, cols, nqb;
  float ds, thresh;
  float* sl;  // staged lines of the tile's queries
  float* kx;  // staged key coordinates
  float* ky;

  __device__ bool skip(int b, int qt, int kt) const {
    const int row = qt * flash::BQ / block_q;
    const int col = kt * flash::BK / sub;
    return !tile_any[((long long)b * nqb + row) * cols + col];
  }

  __device__ void stage(int b, int q0, int j0) const {
    if (j0 >= thw) return;  // register tile: no geometry
    const int f = j0 / hw, p0 = j0 % hw;
    for (int i = threadIdx.x; i < flash::BQ * 3; i += blockDim.x) {
      const int r = i / 3, c = i % 3;
      const int qq = q0 + r;
      sl[i] = qq < Lq ? lines[(((long long)b * Lq + qq) * t + f) * 3 + c] : __int_as_float(0x7fc00000);
    }
    // pix2coord: x * ds + ds / 2 - 0.5, left to right in f32
    for (int i = threadIdx.x; i < flash::BK; i += blockDim.x) {
      const int pix = p0 + i;
      const float half_ds = __fmul_rn(ds, 0.5f);
      kx[i] = __fadd_rn(__fadd_rn(__fmul_rn((float)(pix % w), ds), half_ds), -0.5f);
      ky[i] = __fadd_rn(__fadd_rn(__fmul_rn((float)(pix / w), ds), half_ds), -0.5f);
    }
  }

  __device__ bool visible(int, int rb, int, int kj) const {
    if (kj >= thw) return kj - thw < nreg;
    const int i = kj & (flash::BK - 1);
    const float* l = sl + rb * 3;
    const float dist = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l[0], kx[i]), __fmul_rn(l[1], ky[i])), l[2]));
    return dist < thresh;
  }
};

__global__ void __launch_bounds__(flash::WARPS * 32)
epipolar_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ lines, const int* __restrict__ tile_any,
                    bf16* __restrict__ out, int Lq, int Lk, int H, int D, int t, int hw, int w, int nreg,
                    int block_q, int sub, int cols, float scale, float ds, float thresh) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem + flash::core_smem_bytes(D));
  const int thw = t * hw;
  LineMask m{lines, tile_any, Lq, t, thw, hw, w, nreg, block_q, sub, cols, Lq / block_q,
             ds, thresh, stage, stage + flash::BQ * 3, stage + flash::BQ * 3 + flash::BK};
  const int lk_valid = thw + nreg;
  const int nk = (lk_valid + flash::BK - 1) / flash::BK;
  flash::attention_body(q, k, v, out, Lq, Lk, lk_valid, H, D, scale, nk, smem, m);
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk = t*hw + nreg, H, D), out (B, Lq, H, D):
// contiguous bf16. lines (B, Lq, t, 3) f32; tile_any (B, Lq / block_q, cols)
// int32 with cols = (t*hw + block_k) / sub, the register column at
// t*hw / sub. hw and sub multiples of 64, block_q a multiple of 64,
// nreg <= 64, D a multiple of 16 up to 128 (the wrapper checks).
// `scale` is the bf16-rounded softmax scale; `thresh` = ds*sqrt(2)/2 in f32.
extern "C" int epipolar_flash_fwd(const void* q, const void* k, const void* v, const void* lines,
                                  const void* tile_any, void* out, int B, int Lq, int Lk, int H, int D,
                                  int t, int hw, int w, int nreg, int block_q, int sub, int cols,
                                  float scale, float ds, float thresh, void* stream) {
  if (D % 16 != 0 || D > 128 || hw % flash::BK != 0 || sub % flash::BK != 0 || block_q % flash::BQ != 0 ||
      nreg < 0 || nreg > flash::BK || Lk != t * hw + nreg)
    return (int)cudaErrorInvalidValue;
  const int nq = (Lq + flash::BQ - 1) / flash::BQ;
  const size_t smem = flash::core_smem_bytes(D) + STAGE_FLOATS * sizeof(float);
  cudaFuncSetAttribute(epipolar_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  RETURN_IF_ERR();
  dim3 grid(nq, H, B);
  epipolar_fwd_kernel<<<grid, flash::WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lines, (const int*)tile_any, (bf16*)out,
      Lq, Lk, H, D, t, hw, w, nreg, block_q, sub, cols, scale, ds, thresh);
  RETURN_IF_ERR();
  return 0;
}
