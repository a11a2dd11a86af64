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
// The sums run in the tensor cores' order, a fixed one: the result is the
// same from run to run.
//
// What bounds it on an H100: bytes. At large-v3-turbo's decoder (d 1280,
// ffn 5120) and M <= 8 rows, each int8 weight byte meets at most 8 rows, far
// below the ~295 operations a byte at which the tensor cores would be the
// limit: the 13.1 MB of int8 weights are the traffic, about 3.9 us at 3.35
// TB/s, where dequantize-then-matmul writes and reads them again in bf16.
//
// Design: the two products are K6's decode kernel (csrc/q8_decode.cuh: the
// weight's cp.async slab ring, its dequantization on the integer and FMA
// pipes, swap-AB mma.sync, the split-K sum in rank order through a
// thread-block cluster), two launches on the caller's stream for each
// group of up to 32 rows:
//   1. fc1 with the LayerNorm row prologue (every block computes its rows'
//      mean and variance over the whole row and stages bf16(LN(x)) of its
//      K range) and the epilogue + b1, gelu, bf16 store of a (M x ffn,
//      80 KB at M = 8, to device memory: L2);
//   2. fc2 on the rows of a as they are, with the epilogue + b2 + x in x's
//      type. fc2 may go by programmatic dependent launch (on by default;
//      nwt_fused_mlp_q8_set_pdl switches it for the whole process): its blocks
//      start once fc1's main loops are done, issue their first W2 slabs
//      and wait for fc1's end before they stage a, so W2's stream starts
//      under fc1's tail.
// The split of each product is K6's at the same shape (split_k).

#include <atomic>
#include <initializer_list>

#include "q8_decode.cuh"

namespace {

using namespace nwt;

constexpr int K7_GROUP = 32;   // rows a pair of launches: the decode kernel's

// fc2 by programmatic dependent launch: one switch for the whole process
// (nwt_fused_mlp_q8_set_pdl), read once a call
std::atomic<bool> g_pdl{true};

template <typename T, int MT>
cudaError_t launch_group(const T* x, const float* g, const float* be,
                         const int8_t* w1, const float* s1, const float* b1,
                         const int8_t* w2, const float* s2, const float* b2,
                         bf16* act, T* out, int M, int d, int ffn,
                         cudaStream_t st) {
  cudaError_t e = launch_decode<T, MT, true, PDL_TRIGGER>(
      x, w1, s1, M, d, ffn, RowsLayerNorm{g, be}, BiasGeluBf16{b1, act}, st);
  if (e != cudaSuccess) return e;
  return launch_decode<bf16, MT, true, PDL_WAIT>(
      act, w2, s2, M, ffn, d, RowsAsIs{}, BiasResidual<T>{b2, x, out}, st,
      g_pdl.load());
}

template <typename T>
cudaError_t launch_mlp_q8(const T* x, const float* g, const float* be,
                          const int8_t* w1, const float* s1, const float* b1,
                          const int8_t* w2, const float* s2, const float* b2,
                          bf16* act, T* out, int M, int d, int ffn,
                          cudaStream_t st) {
  if (M <= 0 || d <= 0 || ffn <= 0 || d % 32 || ffn % 32)
    return cudaErrorInvalidValue;
  for (const void* p : {(const void*)x, (const void*)g, (const void*)be,
                        (const void*)w1, (const void*)w2, (const void*)act})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  for (int m0 = 0; m0 < M; m0 += K7_GROUP) {
    const int rows = std::min(K7_GROUP, M - m0);
    const T* xg = x + (size_t)m0 * d;
    bf16* ag = act + (size_t)m0 * ffn;
    T* og = out + (size_t)m0 * d;
    const cudaError_t e =
        rows <= 8    ? launch_group<T, 1>(xg, g, be, w1, s1, b1, w2, s2, b2,
                                          ag, og, rows, d, ffn, st)
        : rows <= 16 ? launch_group<T, 2>(xg, g, be, w1, s1, b1, w2, s2, b2,
                                          ag, og, rows, d, ffn, st)
                     : launch_group<T, 4>(xg, g, be, w1, s1, b1, w2, s2, b2,
                                          ag, og, rows, d, ffn, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

// x (M, d) bf16 or f32; g, be (d,) f32; w1 (d, ffn) int8 with s1, b1 (ffn,)
// f32; w2 (ffn, d) int8 with s2, b2 (d,) f32 (the reference's (d_in, d_out)
// layout); act (M, ffn) bf16 scratch; out (M, d) in x's type. d and ffn
// multiples of 32; x, g, be, w1, w2 and act 16-byte aligned.
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
        static_cast<const float*>(b2), static_cast<nwt::bf16*>(act),           \
        static_cast<T*>(out), M, d, ffn,                                       \
        reinterpret_cast<cudaStream_t>(stream));                               \
  }

NWT_MLP_Q8_ENTRY(nwt_fused_mlp_q8, nwt::bf16)
NWT_MLP_Q8_ENTRY(nwt_fused_mlp_q8_f32, float)

// fc2 by programmatic dependent launch (1) or a plain stream-ordered launch
// (0), for every call that follows in this process, on any thread: a
// switch for timing the two, not a per-call option
extern "C" int nwt_fused_mlp_q8_set_pdl(int on) {
  g_pdl.store(on != 0);
  return 0;
}
