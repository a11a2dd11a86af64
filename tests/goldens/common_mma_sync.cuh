// common.cuh as the port's first K10/K11 kernels were built with it (its
// ln_quant_kernel reads a row with scalar loads), for
// tests/goldens/fused_qkv_mma_sync.cu.
//
// Shared device code for the encoder kernels (sm_90a, plain C interface).
//
// Building blocks used by encoder_attention.cu (K1), fused_mlp.cu (K2, K8),
// fused_qkv.cu (K10, K11) and fused_layer.cu (K12):
//
//   * ln_quant_kernel: LayerNorm in f32 (eps 1e-5) of bf16 or f32 rows and
//     dynamic per-row int8 quantization, s = max(absmax, 1e-6) / 127, q = clip(rint(h / s)).
//     This is the Pallas kernels' numerics (encoder_attention.py:416-427,
//     fused_mlp.py:231-239, fused_qkv.py:31-41), not dense_int8_dynamic's
//     1e-8 floor. With LN = false it quantizes the rows as they are (K11's
//     attention input, fused_qkv.py:107-110).
//   * an int8 x int8 -> int32 tiled GEMM on the tensor cores with
//     mma.sync.m16n8k32 (128 x 128 x 64 block tile, 8 warps of 64 x 32).
//     The weight operand stays in the reference (K, N) row-major layout;
//     each tile is transposed into n-major shared memory on the way in, so
//     every fragment register is one 32-bit shared load.
//   * qkv_gemm_kernel: the three (d, d) int8 projections of one quantized
//     row block in one launch (K1 with its q pre-scaled, K10 without; K1's
//     int8 scores take q unscaled in f32).
//   * chunk_gemm_kernel: out = x + b + sum over K chunks of (acc_chunk *
//     s_row_chunk) * s_col, the int32 accumulator flushed into an f32 one
//     at every chunk boundary, chunks in order (K2/K8's fc2 with the
//     per-(row, chunk) requant scales, K1's fused o projection with the
//     per-(row, head pair) ones).
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

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// tanh gelu with f32 internals, op by op in the reference's order:
// (0.5 a) (1 + tanh(c (a + ((0.044715 a) a) a))), c = sqrt(2 / pi); tanhf,
// never a fast approximation (fused_mlp.py:126-128, conv_stem.py:48-50)
__device__ __forceinline__ float gelu_tanh(float a) {
  const float a3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, a), a), a);
  const float th = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(a, a3)));
  return __fmul_rn(__fmul_rn(0.5f, a), __fadd_rn(1.0f, th));
}

// T: the activations' type, bf16 or float (the int8 encoder at f32 compute);
// LN: LayerNorm with g, b first, else the rows are quantized as they are
template <typename T, bool LN = true>
__global__ void __launch_bounds__(LNQ_WARPS * 32)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, int8_t* __restrict__ xq,
                float* __restrict__ sx, int M, int d) {
  extern __shared__ float lnq_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LNQ_WARPS + warp;
  if (row >= M) return;
  float* h = lnq_smem + (size_t)warp * d;
  const T* xr = x + (size_t)row * d;

  float s = 0.f, amax = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = to_f32(xr[c]);
    h[c] = v;
    s += v;
    amax = fmaxf(amax, fabsf(v));
  }
  if (LN) {
    const float mean = __fdiv_rn(warp_sum(s), (float)d);
    float s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      float dv = __fsub_rn(h[c], mean);
      s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
    }
    const float var = __fdiv_rn(warp_sum(s2), (float)d);
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    amax = 0.f;
    for (int c = lane; c < d; c += 32) {
      float v = __fmul_rn(__fsub_rn(h[c], mean), rs);
      v = __fadd_rn(__fmul_rn(v, g[c]), b[c]);
      h[c] = v;
      amax = fmaxf(amax, fabsf(v));
    }
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  for (int c = lane; c < d; c += 32) xq[(size_t)row * d + c] = quant_s8(h[c], scale);
  if (lane == 0) sx[row] = scale;
}

template <typename T, bool LN = true>
inline cudaError_t launch_ln_quant(const T* x, const float* g,
                                   const float* b, int8_t* xq, float* sx,
                                   int M, int d, cudaStream_t st) {
  const size_t smem = (size_t)LNQ_WARPS * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_quant_kernel<T, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_quant_kernel<T, LN><<<(M + LNQ_WARPS - 1) / LNQ_WARPS, LNQ_WARPS * 32,
                           smem, st>>>(x, g, b, xq, sx, M, d);
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

// bf16 x bf16 -> f32 tensor-core tile (K6)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// The block's 128 x 128 tile of A (M, K) @ W (K, N), both int8 row-major,
// K % 64 == 0, N % 128 == 0; rows of A >= M read as zero.
__device__ __forceinline__ void gemm_s8_tile(GemmSmem& sm, const int8_t* A,
                                             const int8_t* W, int m0, int n0,
                                             int M, int K, int N,
                                             int (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int k0 = 0; k0 < K; k0 += GBK) {
    load_a_s8(sm, A, K, m0, k0, M);
    load_b_s8(sm, W, N, k0, n0);
    __syncthreads();
    mma_slab(sm, acc);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// q/k/v projections of quantized rows: grid (d / 128, ceil(M / 128), 3),
// blockIdx.z picks q, k or v. Epilogue (acc * s_row * s_col + bias) in f32,
// q then times q_scale (K1: dh^-0.5; K10: 1, which leaves it unchanged),
// written in OutT.
// ---------------------------------------------------------------------------

template <typename OutT>
struct QKVArgs {
  const int8_t* xq;
  const float* sx;
  const int8_t* w[3];
  const float* s[3];
  const float* bias[3];   // k has none (nullptr)
  OutT* out[3];
  float* q32;             // non-null: q goes here in f32, unscaled
  float q_scale;
  int M, d;
};

template <typename OutT>
__global__ void __launch_bounds__(GTHREADS)
qkv_gemm_kernel(QKVArgs<OutT> p) {
  __shared__ __align__(16) GemmSmem sm;
  const int z = blockIdx.z;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  int acc[4][4][4];
  gemm_s8_tile(sm, p.xq, p.w[z], m0, n0, p.M, p.d, p.d, acc);

  const float* s_col = p.s[z];
  const float* bias = p.bias[z];
  OutT* out = p.out[z];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), c = acc_col(n0, nt, e);
        if (r >= p.M) continue;
        float v = dequant(acc[mt][nt][e], p.sx[r], s_col[c]);
        if (bias) v = __fadd_rn(v, bias[c]);
        if (z == 0 && p.q32) {
          p.q32[(size_t)r * p.d + c] = v;
          continue;
        }
        if (z == 0) v = __fmul_rn(v, p.q_scale);
        out[(size_t)r * p.d + c] = from_f32<OutT>(v);
      }
}

// xq (M, d) int8 and sx (M,) from ln_quant_kernel; weights (d, d) int8
// row-major with (d,) f32 column scales; bq, bv (d,) f32; q, k, v (M, d).
template <typename OutT>
inline cudaError_t launch_qkv_gemm(const void* xq, const void* sx,
                                   const void* wq, const void* sq,
                                   const void* bq, const void* wk,
                                   const void* sk, const void* wv,
                                   const void* sv, const void* bv, void* q,
                                   void* k, void* v, float q_scale, int M,
                                   int d, cudaStream_t st,
                                   float* q32 = nullptr) {
  QKVArgs<OutT> a;
  a.xq = static_cast<const int8_t*>(xq);
  a.sx = static_cast<const float*>(sx);
  a.w[0] = static_cast<const int8_t*>(wq);
  a.w[1] = static_cast<const int8_t*>(wk);
  a.w[2] = static_cast<const int8_t*>(wv);
  a.s[0] = static_cast<const float*>(sq);
  a.s[1] = static_cast<const float*>(sk);
  a.s[2] = static_cast<const float*>(sv);
  a.bias[0] = static_cast<const float*>(bq);
  a.bias[1] = nullptr;
  a.bias[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<OutT*>(q);
  a.out[1] = static_cast<OutT*>(k);
  a.out[2] = static_cast<OutT*>(v);
  a.q32 = q32;
  a.q_scale = q_scale;
  a.M = M;
  a.d = d;
  const dim3 grid(d / GBN, (M + GBM - 1) / GBM, 3);
  qkv_gemm_kernel<OutT><<<grid, GTHREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Residual GEMM with per-(row, chunk) activation scales: grid (N / 128,
// ceil(M / 128)). out = x + b + sum_c (f32(A[:, chunk c] @ W[chunk c, :]) *
// s_rc) * s_col, accumulated in f32 in chunk order; the row-chunk scale s_rc
// is max(amax[r, c], 1e-6) / 127 from float bits (K2/K8's fc2), or read
// from sa[r, c] when amax is null (K1's fused o, chunk 128).
// ---------------------------------------------------------------------------

template <typename T>
struct FC2Args {
  const int8_t* aq;      // (M, F) int8 activations
  const unsigned* amax;  // (M, n_chunks) float bits, or null
  const float* sa;       // (M, n_chunks) scales when amax is null
  const int8_t* w2;      // (F, N) int8 row-major
  const float* s2;       // (N,) column scales
  const float* b2;       // (N,)
  const T* x;            // residual (M, N)
  T* out;                // (M, N)
  int M, d, F, block_f;  // d = N, F = K
};

__device__ __forceinline__ float chunk_scale(const unsigned* amax, int row,
                                             int n_chunks, int chunk) {
  const float m = __uint_as_float(amax[(size_t)row * n_chunks + chunk]);
  return __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
}

template <typename T>
__global__ void __launch_bounds__(GTHREADS)
fc2_gemm_kernel(FC2Args<T> p) {
  __shared__ __align__(16) GemmSmem sm;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  const int n_chunks = p.F / p.block_f;
  int acc[4][4][4];
  float facc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0;
        const int r = acc_row(m0, mt, e), col = acc_col(n0, nt, e);
        facc[mt][nt][e] =
            r < p.M ? __fadd_rn(to_f32(p.x[(size_t)r * p.d + col]), p.b2[col])
                    : 0.f;
      }

  for (int k0 = 0; k0 < p.F; k0 += GBK) {
    const int chunk = k0 / p.block_f;
    load_a_s8(sm, p.aq, p.F, m0, k0, p.M);
    load_b_s8(sm, p.w2, p.d, k0, n0);
    __syncthreads();
    mma_slab(sm, acc);
    __syncthreads();
    if ((k0 + GBK) % p.block_f == 0) {      // chunk boundary: flush
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(m0, mt, e);
          float sa = 0.f;
          if (r < p.M)
            sa = p.amax ? chunk_scale(p.amax, r, n_chunks, chunk)
                        : p.sa[(size_t)r * n_chunks + chunk];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = acc_col(n0, nt, e);
            facc[mt][nt][e] = __fadd_rn(
                facc[mt][nt][e], dequant(acc[mt][nt][e], sa, p.s2[col]));
            acc[mt][nt][e] = 0;
          }
        }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), col = acc_col(n0, nt, e);
        if (r < p.M)
          p.out[(size_t)r * p.d + col] = from_f32<T>(facc[mt][nt][e]);
      }
}

template <typename T>
inline cudaError_t launch_fc2_gemm(const FC2Args<T>& a, cudaStream_t st) {
  fc2_gemm_kernel<T><<<dim3(a.d / GBN, (a.M + GBM - 1) / GBM), GTHREADS, 0,
                       st>>>(a);
  return cudaGetLastError();
}

}  // namespace nwt
