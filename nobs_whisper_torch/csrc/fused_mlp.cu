// K2: out = x + fc2(requant(gelu_tanh(fc1(quant(LN2 x))))) + b2 with int8
// weights, per-row int8 activations and the fc2 input re-quantized per
// (row, FFN chunk).
//
// Replaces the TPU kernel nobs_whisper_tpu/ops/fused_mlp.py::
// encoder_mlp_int8_resident (pallas_call at :298, kernel
// _enc_mlp_res_kernel :211).
//
// Bound on an H100 at large-v3-turbo (M = 1536 rows per window, d = 1280,
// ffn = 5120), per window and layer: 40.3 G int8 operations, about 20 us at
// the published int8 tensor-core peak; about 21 MB of traffic, 6.3 us. The
// kernel is compute-bound.
//
// Design, four launches (mma.sync int8 GEMMs from common.cuh):
//   1. ln_quant_kernel: LN2 + per-row quant of x.
//   2. fc1_gemm_kernel: int8 fc1, epilogue acc * s_row * s_col + b1 and the
//      tanh gelu (constant 0.7978845608028654, never erf), written to device
//      memory in f32, plus the per-(row, chunk) absmax by atomicMax on the
//      float bits (non-negative floats order like their bit patterns).
//   3. requant_kernel: the fc2 input re-quantized with the per-(row, chunk)
//      scale max(absmax, 1e-6)/127, once per element.
//   4. fc2_gemm_kernel: int8 fc2; the int32 accumulator is flushed into an
//      f32 one (initialized to x + b2) at every chunk boundary, as the TPU
//      kernel's acc += p * sa * w2s.
//   The per-(row, chunk) absmax needs the whole chunk row (2560 values)
//   before any of it is quantized; this first version therefore writes
//   fc1's output to device memory (M x ffn f32) and its int8 re-quantized
//   copy (M x ffn) instead of keeping them on chip as the TPU kernel does:
//   about 2 x 31 MB + 2 x 8 MB of extra traffic per window and layer.

#include "common.cuh"

namespace nwt {

struct FC1Args {
  const int8_t* xq;
  const float* sx;
  const int8_t* w1;
  const float* s1;
  const float* b1;
  float* a;              // (M, F) f32
  unsigned* amax;        // (M, n_chunks) float bits
  int M, d, F, block_f;
};

__global__ void __launch_bounds__(GTHREADS)
fc1_gemm_kernel(FC1Args p) {
  __shared__ __align__(16) GemmSmem sm;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.d; k0 += GBK) {
    load_a_s8(sm, p.xq, p.d, m0, k0, p.M);
    load_b_s8(sm, p.w1, p.F, k0, n0);
    __syncthreads();
    mma_slab(sm, acc);
    __syncthreads();
  }

  const int n_chunks = p.F / p.block_f;
  const int chunk = n0 / p.block_f;         // a 128-wide tile is in one chunk
  const float c = 0.7978845608028654f;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    float mx[2] = {0.f, 0.f};               // rows g and g + 8
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), col = acc_col(n0, nt, e);
        if (r >= p.M) continue;
        float v = __fadd_rn(dequant(acc[mt][nt][e], p.sx[r], p.s1[col]),
                            p.b1[col]);
        const float v3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
        const float th = tanhf(__fmul_rn(c, __fadd_rn(v, v3)));
        v = __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, th));
        p.a[(size_t)r * p.F + col] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(v));
      }
    // the 4 lanes of a quad share rows: reduce, then one atomic per row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const int r = acc_row(m0, mt, 2 * h);
      if ((threadIdx.x & 3) == 0 && r < p.M)
        atomicMax(p.amax + (size_t)r * n_chunks + chunk, __float_as_uint(mx[h]));
    }
  }
}

struct FC2Args {
  const int8_t* aq;      // (M, F) re-quantized gelu output
  const unsigned* amax;  // (M, n_chunks)
  const int8_t* w2;
  const float* s2;
  const float* b2;
  const bf16* x;         // residual (M, d)
  bf16* out;             // (M, d)
  int M, d, F, block_f;
};

__device__ __forceinline__ float chunk_scale(const unsigned* amax, int row,
                                             int n_chunks, int chunk) {
  const float m = __uint_as_float(amax[(size_t)row * n_chunks + chunk]);
  return __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
}

// fc2 input: aq = clip(rint(a / s)) with s the (row, chunk) scale; four
// consecutive values per thread (a chunk is a multiple of 128 wide).
__global__ void __launch_bounds__(256)
requant_kernel(const float* __restrict__ a, const unsigned* __restrict__ amax,
               int8_t* __restrict__ aq, int M, int F, int block_f) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= (size_t)M * F) return;
  const int r = (int)(i / F), c = (int)(i % F);
  const float s = chunk_scale(amax, r, F / block_f, c / block_f);
  const float4 v = *reinterpret_cast<const float4*>(a + i);
  *reinterpret_cast<uint32_t*>(aq + i) =
      (uint32_t)(uint8_t)quant_s8(v.x, s) |
      ((uint32_t)(uint8_t)quant_s8(v.y, s) << 8) |
      ((uint32_t)(uint8_t)quant_s8(v.z, s) << 16) |
      ((uint32_t)(uint8_t)quant_s8(v.w, s) << 24);
}

__global__ void __launch_bounds__(GTHREADS)
fc2_gemm_kernel(FC2Args p) {
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
            r < p.M ? __fadd_rn(__bfloat162float(p.x[(size_t)r * p.d + col]),
                                p.b2[col])
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
          const float sa = r < p.M ? chunk_scale(p.amax, r, n_chunks, chunk)
                                   : 0.f;
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
          p.out[(size_t)r * p.d + col] = __float2bfloat16_rn(facc[mt][nt][e]);
      }
}

}  // namespace nwt

using namespace nwt;

// x (M, d) bf16; w1 (d, F) and w2 (F, d) int8 row-major (d_in, d_out) with
// f32 column scales s1 (F,), s2 (d,); ln_g, ln_b, b2 (d,), b1 (F,) f32.
// d % 128 == 0, F % block_f == 0, block_f % 128 == 0. Workspace: xq (M, d)
// int8, sx (M,) f32, a (M, F) f32, amax (M, F / block_f) u32, aq (M, F)
// int8. Writes out (M, d) bf16.
extern "C" int nwt_encoder_mlp_int8(
    const void* x, const void* ln_g, const void* ln_b,
    const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2,
    void* out, void* xq, void* sx, void* a, void* amax, void* aq,
    int M, int d, int F, int block_f, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(amax, 0, (size_t)M * (F / block_f) * sizeof(unsigned),
                      st);
  if (e != cudaSuccess) return (int)e;

  FC1Args f1;
  f1.xq = static_cast<const int8_t*>(xq);
  f1.sx = static_cast<const float*>(sx);
  f1.w1 = static_cast<const int8_t*>(w1);
  f1.s1 = static_cast<const float*>(s1);
  f1.b1 = static_cast<const float*>(b1);
  f1.a = static_cast<float*>(a);
  f1.amax = static_cast<unsigned*>(amax);
  f1.M = M;
  f1.d = d;
  f1.F = F;
  f1.block_f = block_f;
  fc1_gemm_kernel<<<dim3(F / GBN, (M + GBM - 1) / GBM), GTHREADS, 0, st>>>(f1);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t n4 = (size_t)M * F / 4;
  requant_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(a), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(aq), M, F, block_f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  FC2Args f2;
  f2.aq = static_cast<const int8_t*>(aq);
  f2.amax = static_cast<const unsigned*>(amax);
  f2.w2 = static_cast<const int8_t*>(w2);
  f2.s2 = static_cast<const float*>(s2);
  f2.b2 = static_cast<const float*>(b2);
  f2.x = static_cast<const bf16*>(x);
  f2.out = static_cast<bf16*>(out);
  f2.M = M;
  f2.d = d;
  f2.F = F;
  f2.block_f = block_f;
  fc2_gemm_kernel<<<dim3(d / GBN, (M + GBM - 1) / GBM), GTHREADS, 0, st>>>(f2);
  return (int)cudaGetLastError();
}
