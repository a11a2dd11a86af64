// The port's first K1 projections (K1's LN1 + quantization, its q/k/v
// GEMM, and with the o projection fused the per-pair quantization and the
// o GEMM; mma.sync int8 GEMMs reading the (d_in, d_out) weights as
// stored), kept beside the tests as the bits reference for
// csrc/encoder_attention.cu's K1 and csrc/fused_layer.cu's K12, whose
// projections run on csrc/proj_wgmma.cuh's int8 wgmma kernels: both
// compute the same function with exact int32 sums and the same epilogue
// order, so the two give the same bits (tests/test_torch_kernels_gpu.py
// builds this file on the card). It includes common_mma_sync.cuh, the
// common.cuh those GEMMs lived in. The attention between the two steps is
// K1's own kernel, the same code before and after.

#include "common_mma_sync.cuh"

using namespace nwt;

// x (M, d) bf16; ln_g, ln_b, bq, bv (d,) f32; wq, wk, wv (d, d) int8
// row-major (d_in, d_out) with (d,) f32 column scales. Writes xq (M, d)
// int8, sx (M,) f32 and k, v (M, d) bf16; q (M, d) bf16 times q_scale, or
// with q32 set f32 and unscaled (K1's int8 scores).
extern "C" int nwt_k1_qkv_mma_sync(const void* x, const void* ln_g,
                                   const void* ln_b, const void* wq,
                                   const void* sq, const void* bq,
                                   const void* wk, const void* sk,
                                   const void* wv, const void* sv,
                                   const void* bv, void* q, void* k, void* v,
                                   void* xq, void* sx, float q_scale, int M,
                                   int d, int q32, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qkv_gemm<bf16>(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q,
                                    k, v, q_scale, M, d, st,
                                    q32 ? static_cast<float*>(q) : nullptr);
}

// a32 (M, d) f32, the attention's output; wo (d, d) int8 row-major with
// (d,) f32 column scales so; bo (d,) f32; x (M, d) bf16. Writes aq (M, d)
// int8 and sa (M, d / 128) f32 (each row's head pairs quantized apart) and
// out = x + bo + the pairs' products in order, (M, d) bf16.
extern "C" int nwt_k1_o_mma_sync(const void* a32, const void* wo,
                                 const void* so, const void* bo,
                                 const void* x, void* out, void* aq,
                                 void* sa, int M, int d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_quant<float, false>(
      static_cast<const float*>(a32), nullptr, nullptr,
      static_cast<int8_t*>(aq), static_cast<float*>(sa), M * (d / 128), 128,
      st);
  if (e != cudaSuccess) return (int)e;
  FC2Args<bf16> f;
  f.aq = static_cast<const int8_t*>(aq);
  f.amax = nullptr;
  f.sa = static_cast<const float*>(sa);
  f.w2 = static_cast<const int8_t*>(wo);
  f.s2 = static_cast<const float*>(so);
  f.b2 = static_cast<const float*>(bo);
  f.x = static_cast<const bf16*>(x);
  f.out = static_cast<bf16*>(out);
  f.M = M;
  f.d = d;
  f.F = d;
  f.block_f = 128;
  return (int)launch_fc2_gemm(f, st);
}
