// Shared device code for the encoder kernels (sm_90a, plain C interface).
//
// Two building blocks used by both encoder_attention.cu (K1) and
// fused_mlp.cu (K2):
//
//   * ln_quant_kernel: LayerNorm in f32 (eps 1e-5) and dynamic per-row int8
//     quantization, s = max(absmax, 1e-6) / 127, q = clip(rint(h / s)).
//     This is the Pallas kernels' numerics (encoder_attention.py:416-427,
//     fused_mlp.py:231-239), not dense_int8_dynamic's 1e-8 floor.
//   * an int8 x int8 -> int32 tiled GEMM on the tensor cores with
//     mma.sync.m16n8k32 (128 x 128 x 64 block tile, 8 warps of 64 x 32).
//     The weight operand stays in the reference (K, N) row-major layout;
//     each tile is transposed into n-major shared memory on the way in, so
//     every fragment register is one 32-bit shared load.
//
// Arithmetic in the epilogues uses the _rn intrinsics so that nvcc does not
// contract a multiply and an add into one FMA: the plain PyTorch versions
// round after every operation, as the reference does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nwt {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// LayerNorm + per-row int8 quantization: one warp per row, the row's f32
// values staged in shared memory (d * 4 bytes per warp).
// ---------------------------------------------------------------------------

constexpr int LNQ_WARPS = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quant_s8(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

__global__ void __launch_bounds__(LNQ_WARPS * 32)
ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, int8_t* __restrict__ xq,
                float* __restrict__ sx, int M, int d) {
  extern __shared__ float lnq_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LNQ_WARPS + warp;
  if (row >= M) return;
  float* h = lnq_smem + (size_t)warp * d;
  const bf16* xr = x + (size_t)row * d;

  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = __bfloat162float(xr[c]);
    h[c] = v;
    s += v;
  }
  const float mean = __fdiv_rn(warp_sum(s), (float)d);
  float s2 = 0.f;
  for (int c = lane; c < d; c += 32) {
    float dv = __fsub_rn(h[c], mean);
    s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
  }
  const float var = __fdiv_rn(warp_sum(s2), (float)d);
  const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = __fmul_rn(__fsub_rn(h[c], mean), rs);
    v = __fadd_rn(__fmul_rn(v, g[c]), b[c]);
    h[c] = v;
    amax = fmaxf(amax, fabsf(v));
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  for (int c = lane; c < d; c += 32) xq[(size_t)row * d + c] = quant_s8(h[c], scale);
  if (lane == 0) sx[row] = scale;
}

inline cudaError_t launch_ln_quant(const bf16* x, const float* g,
                                   const float* b, int8_t* xq, float* sx,
                                   int M, int d, cudaStream_t st) {
  const size_t smem = (size_t)LNQ_WARPS * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_quant_kernel<<<(M + LNQ_WARPS - 1) / LNQ_WARPS, LNQ_WARPS * 32, smem,
                    st>>>(x, g, b, xq, sx, M, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 GEMM main loop pieces. Block tile BM x BN x BK = 128 x 128 x 64,
// 256 threads = 8 warps laid out 2 (M) x 4 (N); each warp owns a 64 x 32
// tile = 4 x 4 mma.m16n8k32 tiles, 64 int32 accumulators per thread.
// Shared rows are padded to 80 bytes (20 words): the fragment loads
// (row g, word t) of a warp then hit 32 distinct banks.
// ---------------------------------------------------------------------------

constexpr int GBM = 128, GBN = 128, GBK = 64, GLDS = GBK + 16;
constexpr int GTHREADS = 256;

struct GemmSmem {
  uint8_t a[GBM][GLDS];   // [m][k]
  uint8_t b[GBN][GLDS];   // [n][k]  (transposed from the (K, N) weight)
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A tile from an int8 (M, K) row-major matrix; rows >= M read as zero.
__device__ __forceinline__ void load_a_s8(GemmSmem& sm, const int8_t* A,
                                          int lda, int m0, int k0, int M) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * GTHREADS;      // 512 chunks of 16 B
    const int r = c >> 2, kc = (c & 3) * 16;
    int4 v = make_int4(0, 0, 0, 0);
    if (m0 + r < M)
      v = *reinterpret_cast<const int4*>(A + (size_t)(m0 + r) * lda + k0 + kc);
    *reinterpret_cast<int4*>(&sm.a[r][kc]) = v;
  }
}

// B tile from an int8 (K, N) row-major weight, stored transposed [n][k].
__device__ __forceinline__ void load_b_s8(GemmSmem& sm, const int8_t* W,
                                          int ldw, int k0, int n0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * GTHREADS;      // 512 chunks of 16 B
    const int kr = c >> 3, nc = (c & 7) * 16;
    int4 v = *reinterpret_cast<const int4*>(W + (size_t)(k0 + kr) * ldw + n0 + nc);
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
    for (int j = 0; j < 16; ++j) sm.b[nc + j][kr] = p[j];
  }
}

// One BK = 64 slab: two k32 steps of the warp's 4 x 4 mma tiles.
__device__ __forceinline__ void mma_slab(const GemmSmem& sm,
                                         int (&acc)[4][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < GBK; ks += 32) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const int r = wm * 64 + mt * 16 + g;
      af[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.a[r][ks + t * 4]);
      af[mt][1] = *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][ks + t * 4]);
      af[mt][2] = *reinterpret_cast<const uint32_t*>(&sm.a[r][ks + 16 + t * 4]);
      af[mt][3] = *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][ks + 16 + t * 4]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = wn * 32 + nt * 8 + g;
      bf[nt][0] = *reinterpret_cast<const uint32_t*>(&sm.b[n][ks + t * 4]);
      bf[nt][1] = *reinterpret_cast<const uint32_t*>(&sm.b[n][ks + 16 + t * 4]);
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// Coordinates of accumulator element e of tile (mt, nt) for this thread.
__device__ __forceinline__ int acc_row(int m0, int mt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return m0 + (warp >> 2) * 64 + mt * 16 + (lane >> 2) + (e >= 2 ? 8 : 0);
}

__device__ __forceinline__ int acc_col(int n0, int nt, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return n0 + (warp & 3) * 32 + nt * 8 + (lane & 3) * 2 + (e & 1);
}

// acc_int32 -> f32 x row scale x column scale, in that order.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

}  // namespace nwt
