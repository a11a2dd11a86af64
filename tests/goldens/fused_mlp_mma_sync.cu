// The port's first K2/K8 kernels (mma.sync int8 GEMMs, fc1's f32 output
// through device memory, a requant pass), kept beside the tests as the
// bits reference for csrc/fused_mlp.cu: both compute the same function with
// exact int32 sums and an order-free absmax, so the two give the same bits
// (tests/test_torch_kernels_gpu.py builds this file on the card). Its C
// entry points take the weights in the reference's (d_in, d_out) layout and
// always the (M, F) f32 workspace a.
//
// K2 and K8: out = x + fc2(requant(gelu_tanh(fc1(quant(LN2 x))))) + b2
// with int8 weights, per-row int8 activations and the fc2 input
// re-quantized per (row, FFN chunk).
//
// Replaces two TPU kernels of nobs_whisper_tpu/ops/fused_mlp.py, both
// hand-written here, neither a library call:
//   K2 nwt_encoder_mlp_int8[_f32]: encoder_mlp_int8_resident (pallas_call at
//      :298, kernel _enc_mlp_res_kernel :211), the quantized encoder's
//      default MLP, block_f 2560 at its call site (whisper.py:551);
//   K8 nwt_encoder_mlp_int8_chunked[_f32]: encoder_mlp_int8 (pallas_call at
//      :173, kernel _enc_mlp_kernel :94), taken under NWT_MLP_CHUNKED with
//      block_f 1280.
// The two TPU kernels compute one function (tests/test_fused_mlp.py:81-108
// holds them equal at equal block_f): "resident" keeps the whole w1/w2 in
// VMEM across the row tiles, "chunked" streams them chunk by chunk. That is
// a VMEM residency choice with no counterpart on this card, where every
// block reads its weight tiles through L2 and fc1's output goes through
// device memory in either case. What K8 changes is the function's one
// parameter: the granularity block_f at which the fc2 input is
// re-quantized. So K8 is its own entry point, counted on its own, on the
// same templated kernels below.
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
//   4. fc2_gemm_kernel (common.cuh): int8 fc2; the int32 accumulator is
//      flushed into an f32 one (initialized to x + b2) at every chunk
//      boundary, as the TPU kernel's acc += p * sa * w2s.
//   The per-(row, chunk) absmax needs the whole chunk row (2560 values)
//   before any of it is quantized; this first version therefore writes
//   fc1's output to device memory (M x ffn f32) and its int8 re-quantized
//   copy (M x ffn) instead of keeping them on chip as the TPU kernel does:
//   about 2 x 31 MB + 2 x 8 MB of extra traffic per window and layer.
//
// Activations are bf16 (nwt_encoder_mlp_int8) or f32
// (nwt_encoder_mlp_int8_f32): the reference gates K2 on no dtype, so an
// int8 encoder at f32 compute runs it too. Only the types of x and out
// differ (ln_quant_kernel and fc2_gemm_kernel are templated on them); the
// arithmetic is f32 in both, as in the TPU kernel (x cast to f32, the
// accumulator cast to out's type at the end).

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
  gemm_s8_tile(sm, p.xq, p.w1, m0, n0, p.M, p.d, p.F, acc);

  const int n_chunks = p.F / p.block_f;
  const int chunk = n0 / p.block_f;         // a 128-wide tile is in one chunk
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
        v = gelu_tanh(v);
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

// x (M, d) of type T (bf16, or float for the int8 encoder at f32 compute);
// w1 (d, F) and w2 (F, d) int8 row-major (d_in, d_out) with f32 column
// scales s1 (F,), s2 (d,); ln_g, ln_b, b2 (d,), b1 (F,) f32. d % 128 == 0,
// F % block_f == 0, block_f % 128 == 0. Workspace: xq (M, d) int8, sx (M,)
// f32, a (M, F) f32, amax (M, F / block_f) u32, aq (M, F) int8. Writes out
// (M, d) of type T.
template <typename T>
int encoder_mlp_int8(
    const void* x, const void* ln_g, const void* ln_b,
    const void* w1, const void* s1, const void* b1,
    const void* w2, const void* s2, const void* b2,
    void* out, void* xq, void* sx, void* a, void* amax, void* aq,
    int M, int d, int F, int block_f, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
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

  FC2Args<T> f2;
  f2.aq = static_cast<const int8_t*>(aq);
  f2.amax = static_cast<const unsigned*>(amax);
  f2.sa = nullptr;
  f2.w2 = static_cast<const int8_t*>(w2);
  f2.s2 = static_cast<const float*>(s2);
  f2.b2 = static_cast<const float*>(b2);
  f2.x = static_cast<const T*>(x);
  f2.out = static_cast<T*>(out);
  f2.M = M;
  f2.d = d;
  f2.F = F;
  f2.block_f = block_f;
  return (int)launch_fc2_gemm(f2, st);
}

}  // namespace nwt

using namespace nwt;

#define NWT_MLP_ARGS                                                      \
  const void *x, const void *ln_g, const void *ln_b, const void *w1,      \
      const void *s1, const void *b1, const void *w2, const void *s2,     \
      const void *b2, void *out, void *xq, void *sx, void *a, void *amax, \
      void *aq, int M, int d, int F, int block_f, void *stream
#define NWT_MLP_PASS \
  x, ln_g, ln_b, w1, s1, b1, w2, s2, b2, out, xq, sx, a, amax, aq, M, d, F, \
      block_f, stream

extern "C" int nwt_encoder_mlp_int8(NWT_MLP_ARGS) {
  return encoder_mlp_int8<bf16>(NWT_MLP_PASS);
}

// the same function on f32 activations: the arithmetic is f32 throughout
// already; only the residual read and the output write change type
extern "C" int nwt_encoder_mlp_int8_f32(NWT_MLP_ARGS) {
  return encoder_mlp_int8<float>(NWT_MLP_PASS);
}

// K8: the chunked kernel's entry points (its default block_f is 1280)
extern "C" int nwt_encoder_mlp_int8_chunked(NWT_MLP_ARGS) {
  return encoder_mlp_int8<bf16>(NWT_MLP_PASS);
}

extern "C" int nwt_encoder_mlp_int8_chunked_f32(NWT_MLP_ARGS) {
  return encoder_mlp_int8<float>(NWT_MLP_PASS);
}
