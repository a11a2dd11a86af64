// K7 nwt_fused_mlp_q8: the decoder MLP for a few rows,
//   out = x + (gelu_tanh(bf16(LN(x)) @ W1 + b1) in bf16) @ W2 + b2,
// with int8 weights dequantized to bf16 on chip, x (M, d) bf16 or f32.
//
// Replaces nobs_whisper_tpu/ops/fused_mlp.py::fused_mlp_q8 (pallas_call at
// :63, kernel _fused_mlp_kernel :27). Numerics are the TPU kernel's, at its
// rounding points:
//   h = LN(x) in f32 (biased variance, rsqrt(var + 1e-5), * g + b);
//   W = bf16(bf16(q) * bf16(s)) per column (the product of two bf16 values,
//       rounded once more to bf16);
//   a = bf16(h) @ W1 + b1 with exact products and f32 sums, then the tanh
//       gelu in f32 (gelu_tanh in common.cuh: the TPU kernel's, not the
//       reference decoder's erf gelu);
//   o = bf16(a) @ W2 + b2 likewise; out = T(f32(x) + o).
// The sums run in another order than the TPU's matmuls, in a fixed order:
// the result is the same from run to run.
//
// What bounds it on an H100: bytes. At large-v3-turbo's decoder (d 1280,
// ffn 5120) and M <= 8 rows, each int8 weight byte meets at most 8 rows, far
// below the ~295 operations a byte at which the tensor cores would be the
// limit: the 13.1 MB of int8 weights are the traffic, about 3.9 us at 3.35
// TB/s, where dequantize-then-matmul writes and reads them again in bf16.
//
// Design: two launches on the caller's stream, each reading its weight once.
//   1. fc1: a block owns 32 columns of W1 and the rows of one tile of up to
//      8 rows. It recomputes the tile's LayerNorm (cheap: 8 x d values) into
//      shared memory, rounded to bf16, while its first weight loads are in
//      flight: 4 threads a weight row, 8 bytes each, 64 rows a pass, the
//      next 4 passes' loads issued before the current 4 passes' arithmetic.
//      Each thread dequantizes its 8 weights a row in registers (scales
//      rounded to bf16 once, held in registers) and adds their products
//      with the tile's rows on FFMA (a bf16 x bf16 product is exact in
//      f32). Partial sums meet by warp shuffles and then across the 8 warps
//      in shared memory, always in the same order (no atomics: split sums
//      over K would make the f32 order, and so the result, vary). The
//      epilogue adds b1, applies the gelu and writes bf16 a (M x ffn, 80 KB
//      at M = 8) to device memory.
//   2. fc2: the same loop over W2, with the tile's rows of a staged in
//      shared memory from device memory (L2) while the first weight loads
//      are in flight, one thread a weight row and 8 columns a block, so
//      that d = 1280 columns still give 160 blocks; the epilogue adds b2
//      and the residual. At most 128 registers a thread, so that two blocks
//      share a multiprocessor and a launch's 160 blocks are resident at once.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py, device time in a CUDA
// graph) this takes 25 us at M = 1 and 39 us at M = 8 against the 3.9 us
// bound. Issuing all 20 passes' loads at once was slower (37 and 49 us), so
// the wait for device memory is not what limits it; each block reads an 8-
// or 32-byte column strip of every weight row, scattered sectors that a
// faster design would replace with whole lines.
// The row tile is a template (1, 2, 4 or 8 rows): a tile's rows beyond M
// run the same FFMA as real ones, and chip_smoke.py's by-rows timing shows
// M = 5-7 (the 8-row tile) as slow as M = 8, so a decode step's batch of 1
// through the 8-row tile would take 1.5x the 1-row tile's time. More than
// 8 rows run several tiles.

#include <type_traits>

#include "common.cuh"

namespace nwt {

constexpr int MQ_THREADS = 256, MQ_WARPS = MQ_THREADS / 32;
constexpr int MQ_UNROLL = 4;   // passes of weight loads in flight

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// FC1: the A rows are LN(x), computed here; else the bf16 (M, K) matrix a.
// Either way the tile's A rows are staged in shared memory as bf16. TPR
// threads a weight row, 8 columns (bytes) each: BN = 8 TPR columns.
template <typename T, int MT, int TPR, bool FC1>
__global__ void __launch_bounds__(MQ_THREADS, 2)
fused_mlp_q8_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ be,
                    const bf16* __restrict__ act, const int8_t* __restrict__ w,
                    const float* __restrict__ s, const float* __restrict__ bias,
                    bf16* __restrict__ act_out, T* __restrict__ out, int M,
                    int K, int N) {
  constexpr int BN = 8 * TPR, RPP = MQ_THREADS / TPR;   // rows a pass
  constexpr int STEP = MQ_UNROLL * RPP;
  extern __shared__ __align__(16) bf16 mq_rows[];       // [MT][K]
  __shared__ float red[MQ_WARPS][MT][BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * MT;
  const int cg = tid % TPR, kr = tid / TPR;

  // the first passes of weight loads are in flight during the prologue
  const int8_t* wc = w + n0 + 8 * cg;
  uint2 q[MQ_UNROLL];
  auto load = [&](int k0) {
#pragma unroll
    for (int u = 0; u < MQ_UNROLL; ++u) {
      const int k = k0 + u * RPP;
      q[u] = k < K ? __ldg(reinterpret_cast<const uint2*>(wc + (size_t)k * N))
                   : make_uint2(0u, 0u);
    }
  };
  load(kr);

  if constexpr (FC1) {
    // LayerNorm of the tile's rows, one warp a row, the arithmetic of
    // ln_quant_kernel; x is read once a pass (from L1/L2 after the first)
    for (int m = warp; m < MT; m += MQ_WARPS) {
      bf16* h = mq_rows + (size_t)m * K;
      const int r = r0 + m;
      if (r >= M) {
        for (int c = lane; c < K; c += 32) h[c] = __float2bfloat16_rn(0.f);
        continue;
      }
      const T* xr = x + (size_t)r * K;
      float sum = 0.f;
      for (int c = lane; c < K; c += 32) sum += to_f32(xr[c]);
      const float mean = __fdiv_rn(warp_sum(sum), (float)K);
      float s2 = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float dv = __fsub_rn(to_f32(xr[c]), mean);
        s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
      }
      const float var = __fdiv_rn(warp_sum(s2), (float)K);
      const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
      for (int c = lane; c < K; c += 32) {
        const float v = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rs);
        h[c] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(v, g[c]), be[c]));
      }
    }
  } else {
    // the tile's rows of a, 16 bytes a thread (K % 8 == 0)
    const int per_row = K / 8;
    for (int e = tid; e < MT * per_row; e += MQ_THREADS) {
      const int m = e / per_row, c8 = e % per_row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + m < M)
        v = *reinterpret_cast<const uint4*>(act + (size_t)(r0 + m) * K +
                                            8 * c8);
      *reinterpret_cast<uint4*>(mq_rows + (size_t)m * K + 8 * c8) = v;
    }
  }
  __syncthreads();

  float sc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = bf16_round(s[n0 + 8 * cg + j]);
  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;

  for (int k0 = kr; k0 < K; k0 += STEP) {
    uint2 cur[MQ_UNROLL];
#pragma unroll
    for (int u = 0; u < MQ_UNROLL; ++u) cur[u] = q[u];
    if (k0 + STEP < K) load(k0 + STEP);      // the next passes' weights
#pragma unroll
    for (int u = 0; u < MQ_UNROLL; ++u) {
      const int k = k0 + u * RPP;
      if (k >= K) break;
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t word = j < 4 ? cur[u].x : cur[u].y;
        wv[j] = bf16_round((float)(int8_t)(word >> (8 * (j & 3))) * sc[j]);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float av = __bfloat162float(mq_rows[(size_t)m * K + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(av, wv[j], acc[m][j]);
      }
    }
  }

  // lanes with the same column group hold partials of the same outputs
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[m][j];
#pragma unroll
      for (int o = TPR; o < 32; o <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane < TPR) red[warp][m][8 * lane + j] = v;
    }
  __syncthreads();
  for (int e = tid; e < MT * BN; e += MQ_THREADS) {
    const int m = e / BN, c = e % BN, r = r0 + m, n = n0 + c;
    if (r >= M) continue;
    float v = red[0][m][c];
#pragma unroll
    for (int wi = 1; wi < MQ_WARPS; ++wi) v = __fadd_rn(v, red[wi][m][c]);
    v = __fadd_rn(v, bias[n]);
    if constexpr (FC1) {
      act_out[(size_t)r * N + n] = __float2bfloat16_rn(gelu_tanh(v));
    } else {
      const size_t i = (size_t)r * N + n;
      out[i] = from_f32<T>(__fadd_rn(to_f32(x[i]), v));
    }
  }
}

template <typename T, int MT>
inline cudaError_t launch_mlp_q8_tile(const T* x, const float* g,
                                      const float* be, const int8_t* w1,
                                      const float* s1, const float* b1,
                                      const int8_t* w2, const float* s2,
                                      const float* b2, bf16* act, T* out,
                                      int M, int d, int ffn, cudaStream_t st) {
  const int tiles = (M + MT - 1) / MT;
  auto fc1 = fused_mlp_q8_kernel<T, MT, 4, true>;
  auto fc2 = fused_mlp_q8_kernel<T, MT, 1, false>;
  const size_t smem1 = (size_t)MT * d * sizeof(bf16);
  const size_t smem2 = (size_t)MT * ffn * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      fc1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        fc2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return e;
  fc1<<<dim3(ffn / 32, tiles), MQ_THREADS, smem1, st>>>(
      x, g, be, nullptr, w1, s1, b1, act, nullptr, M, d, ffn);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fc2<<<dim3(d / 8, tiles), MQ_THREADS, smem2, st>>>(
      x, nullptr, nullptr, act, w2, s2, b2, nullptr, out, M, ffn, d);
  return cudaGetLastError();
}

template <typename T>
inline cudaError_t launch_mlp_q8(const T* x, const float* g, const float* be,
                                 const int8_t* w1, const float* s1,
                                 const float* b1, const int8_t* w2,
                                 const float* s2, const float* b2, bf16* act,
                                 T* out, int M, int d, int ffn,
                                 cudaStream_t st) {
  if (M <= 0 || d <= 0 || ffn <= 0 || d % 32 || ffn % 32 ||
      (size_t)8 * (d > ffn ? d : ffn) * sizeof(bf16) > 200 * 1024)
    return cudaErrorInvalidValue;
  auto run = [&](auto mt) {
    return launch_mlp_q8_tile<T, decltype(mt)::value>(
        x, g, be, w1, s1, b1, w2, s2, b2, act, out, M, d, ffn, st);
  };
  if (M == 1) return run(std::integral_constant<int, 1>());
  if (M == 2) return run(std::integral_constant<int, 2>());
  if (M <= 4) return run(std::integral_constant<int, 4>());
  return run(std::integral_constant<int, 8>());
}

}  // namespace nwt

using namespace nwt;

// x (M, d) bf16 or f32; g, be (d,) f32; w1 (d, ffn) int8 with s1, b1 (ffn,)
// f32; w2 (ffn, d) int8 with s2, b2 (d,) f32 (the reference's (d_in, d_out)
// layout); act (M, ffn) bf16 scratch; out (M, d) in x's type.
// d and ffn multiples of 32.
#define NWT_MLP_Q8_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const void* x, const void* g, const void* be,            \
                      const void* w1, const void* s1, const void* b1,          \
                      const void* w2, const void* s2, const void* b2,          \
                      void* act, void* out, int M, int d, int ffn,             \
                      void* stream) {                                          \
    return (int)launch_mlp_q8(                                                 \
        static_cast<const T*>(x), static_cast<const float*>(g),                \
        static_cast<const float*>(be), static_cast<const int8_t*>(w1),         \
        static_cast<const float*>(s1), static_cast<const float*>(b1),          \
        static_cast<const int8_t*>(w2), static_cast<const float*>(s2),         \
        static_cast<const float*>(b2), static_cast<bf16*>(act),                \
        static_cast<T*>(out), M, d, ffn,                                       \
        reinterpret_cast<cudaStream_t>(stream));                               \
  }

NWT_MLP_Q8_ENTRY(nwt_fused_mlp_q8, bf16)
NWT_MLP_Q8_ENTRY(nwt_fused_mlp_q8_f32, float)
