// The port's first K10/K11 kernels (a scalar-load LN + quantization pass,
// then common.cuh's mma.sync int8 GEMMs reading the (d_in, d_out) weights
// as stored), kept beside the tests as the bits reference for
// csrc/fused_qkv.cu: both compute the same function with exact int32 sums
// and the same epilogue order, so the two give the same bits
// (tests/test_torch_kernels_gpu.py builds this file on the card). It
// includes common_mma_sync.cuh, the common.cuh it was built with, whose
// ln_quant_kernel is the first, scalar-load one. Its C entries take the
// same arguments as the checkout's, the weights in the reference layout.
//
// The int8 encoder's attention projections outside the attention kernel,
// taken under NWT_INT8_QKV (models/whisper.py::encoder_kernel_gates):
//
//   K10 nwt_encoder_qkv_int8[_f32]: LN1 -> per-row int8 quant -> the three
//       int8 (d, d) projections q, k, v, each dequantized per row and
//       channel, plus the q and v biases, written in the activations' type.
//       Replaces nobs_whisper_tpu/ops/fused_qkv.py::encoder_qkv_int8
//       (pallas_call at :79, kernel _qkv_kernel :44 with _ln_quant :31).
//   K11 nwt_residual_o_int8[_f32]: x + o_proj(a), a quantized per row
//       without LN. Replaces residual_o_int8 (pallas_call at :131, kernel
//       _res_o_kernel :106).
//
// Numerics are the TPU kernels': LN in f32 with eps 1e-5, row scale
// max(absmax, 1e-6) / 127, q = clip(rint(h / s)), exact int32 products,
// then (acc * s_row) * s_col (+ bias) in f32; K11 adds the residual in f32
// and rounds once to the activations' type. The activations are bf16
// (the serving encoder) or f32 (an int8 encoder at f32 compute: the
// reference's NWT_INT8_QKV gate tests no dtype).
//
// Bounds on an H100 at M = 3000 rows (two windows of 1500), d = 1280:
// K10 is 3 x 9.8 G int8 operations, about 15 us at the published int8
// tensor-core peak, against 35.6 MB of traffic (x read, three bf16 outputs
// written, the weights), about 11 us: compute-bound. K11 is 9.8 G operations,
// about 5 us, against 24.7 MB (x and a read, out written), about 7 us:
// bound by bytes.
//
// Design: two launches each, on the building blocks of common.cuh.
//   1. ln_quant_kernel (K10 with LN, K11 without): one warp per row writes
//      the int8 row and its scale. The TPU kernels keep both in VMEM for the
//      matmuls of the same grid step; GPU blocks of one GEMM read a row
//      block once per output tile, so the quantized rows make one round
//      trip through device memory (M x d int8: 3.8 MB).
//   2. the int8 mma.sync GEMM of common.cuh. K10 reuses K1's three-way
//      qkv_gemm_kernel with a q scale of 1 (K1 writes bf16(q dh^-0.5), K10
//      writes q); K11's epilogue reads the residual tile and writes
//      T(f32(x) + ((acc * s_a) * s_o + b_o)). The (d, d) weights (1.6 MB
//      each) are read from L2 by every row block after the first.

#include "common_mma_sync.cuh"

namespace nwt {

template <typename T>
struct ResOArgs {
  const int8_t* aq;     // (M, d) quantized attention output
  const float* sa;      // (M,) its row scales
  const int8_t* w;      // (d, d) int8 o weight
  const float* s;       // (d,) column scales
  const float* bias;    // (d,)
  const T* x;           // (M, d) residual
  T* out;               // (M, d)
  int M, d;
};

template <typename T>
__global__ void __launch_bounds__(GTHREADS)
res_o_gemm_kernel(ResOArgs<T> p) {
  __shared__ __align__(16) GemmSmem sm;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  int acc[4][4][4];
  gemm_s8_tile(sm, p.aq, p.w, m0, n0, p.M, p.d, p.d, acc);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), c = acc_col(n0, nt, e);
        if (r >= p.M) continue;
        const size_t i = (size_t)r * p.d + c;
        const float y =
            __fadd_rn(dequant(acc[mt][nt][e], p.sa[r], p.s[c]), p.bias[c]);
        p.out[i] = from_f32<T>(__fadd_rn(to_f32(p.x[i]), y));
      }
}

// x (M, d) of type T; ln_g, ln_b, bq, bv (d,) f32; wq, wk, wv (d, d) int8
// row-major (d_in, d_out) with (d,) f32 column scales; d % 128 == 0.
// Workspace: xq (M, d) int8, sx (M,) f32. Writes q, k, v (M, d) of type T.
template <typename T>
int encoder_qkv_int8(const void* x, const void* ln_g, const void* ln_b,
                     const void* wq, const void* sq, const void* bq,
                     const void* wk, const void* sk, const void* wv,
                     const void* sv, const void* bv, void* q, void* k,
                     void* v, void* xq, void* sx, int M, int d,
                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant<T>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qkv_gemm<T>(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q,
                                 k, v, 1.0f, M, d, st);
}

// x, a (M, d) of type T; wo (d, d) int8 row-major with (d,) f32 column
// scales so; bo (d,) f32; d % 128 == 0. Workspace: aq (M, d) int8, sa (M,)
// f32. Writes out (M, d) of type T.
template <typename T>
int residual_o_int8(const void* x, const void* a, const void* wo,
                    const void* so, const void* bo, void* out, void* aq,
                    void* sa, int M, int d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant<T, false>(
      static_cast<const T*>(a), nullptr, nullptr, static_cast<int8_t*>(aq),
      static_cast<float*>(sa), M, d, st);
  if (e != cudaSuccess) return (int)e;
  ResOArgs<T> p;
  p.aq = static_cast<const int8_t*>(aq);
  p.sa = static_cast<const float*>(sa);
  p.w = static_cast<const int8_t*>(wo);
  p.s = static_cast<const float*>(so);
  p.bias = static_cast<const float*>(bo);
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.M = M;
  p.d = d;
  res_o_gemm_kernel<T><<<dim3(d / GBN, (M + GBM - 1) / GBM), GTHREADS, 0,
                         st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace nwt

using namespace nwt;

#define NWT_QKV_ARGS                                                        \
  const void *x, const void *ln_g, const void *ln_b, const void *wq,        \
      const void *sq, const void *bq, const void *wk, const void *sk,       \
      const void *wv, const void *sv, const void *bv, void *q, void *k,     \
      void *v, void *xq, void *sx, int M, int d, void *stream
#define NWT_QKV_PASS \
  x, ln_g, ln_b, wq, sq, bq, wk, sk, wv, sv, bv, q, k, v, xq, sx, M, d, stream
#define NWT_RES_O_ARGS                                                      \
  const void *x, const void *a, const void *wo, const void *so,             \
      const void *bo, void *out, void *aq, void *sa, int M, int d,          \
      void *stream
#define NWT_RES_O_PASS x, a, wo, so, bo, out, aq, sa, M, d, stream

extern "C" int nwt_encoder_qkv_int8(NWT_QKV_ARGS) {
  return encoder_qkv_int8<bf16>(NWT_QKV_PASS);
}

extern "C" int nwt_encoder_qkv_int8_f32(NWT_QKV_ARGS) {
  return encoder_qkv_int8<float>(NWT_QKV_PASS);
}

extern "C" int nwt_residual_o_int8(NWT_RES_O_ARGS) {
  return residual_o_int8<bf16>(NWT_RES_O_PASS);
}

extern "C" int nwt_residual_o_int8_f32(NWT_RES_O_ARGS) {
  return residual_o_int8<float>(NWT_RES_O_PASS);
}
