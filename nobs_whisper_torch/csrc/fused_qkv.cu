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
// then (acc * s_row) * s_col (+ bias) in f32 with _rn intrinsics; K11 adds
// the residual in f32 and rounds once to the activations' type. The
// activations are bf16 (the serving encoder) or f32 (an int8 encoder at
// f32 compute: the reference's NWT_INT8_QKV gate tests no dtype). The int32
// sums are exact and the epilogue keeps the order of the port's first,
// mma.sync kernels (tests/goldens/fused_qkv_mma_sync.cu), so these give
// their bits at every shape.
//
// Bounds on an H100 at M = 3000 rows (two windows of 1500), d = 1280:
// K10 is 3 x 9.8 G int8 operations, 0.0149 ms at the published int8
// tensor-core peak, against 35.6 MB of traffic (x read, three bf16 outputs
// written, the weights), 0.0106 ms: compute-bound. K11 is 9.8 G
// operations, 0.0050 ms, against 24.7 MB (x and a read, out written),
// 0.0074 ms: bound by bytes.
//
// Design (sm_90a): two launches each.
//   1. ln_quant_kernel (common.cuh; K10 with LN, K11 without): one warp a
//      row, 16-byte loads, writes the int8 row and its scale. The TPU
//      kernels keep both in VMEM for the matmuls of the same grid step; GPU
//      blocks of one GEMM read a row block once per output tile, so the
//      quantized rows make one round trip through device memory (M x d
//      int8: 3.8 MB), from L2 for the blocks after the first.
//   2. proj_wgmma_kernel (proj_wgmma.cuh, which K1 and K12 launch too):
//      the projections on gemm_s8_wgmma.cuh's TMA ring and int8 wgmma, the
//      weights as their K-major copies (d_out, d_in), made once per weight
//      by the wrapper (ops/quant.py::k_major). A block an SM: 384 threads, the third warpgroup the producer,
//      setmaxnreg moving its registers to the two consumer warpgroups (64
//      rows of the 128 x BN tile each). K10's three projections are one
//      grid of tiles (3 x d / BN column blocks, the projection first, then
//      the row blocks); K11's one. The epilogue writes T(value) into a
//      128 x BN tile of shared memory laid out as the TMA's 128-byte
//      swizzle leaves it (boxes of 128 bytes x 128 rows), and one thread
//      stores the tile with TMA stores, which drop the rows past M.
//      K11 takes a block a tile. Its residual tile comes in the same layout
//      by TMA loads that the producer issues after the ring's (before them
//      measured slower), on an mbarrier of its own, into shared memory
//      beside the ring; the epilogue adds the product into it in place. At
//      bf16 its tiles are 256 columns wide where that grid has 96 tiles or
//      more (M = 3000: 120 tiles, one wave of 132 SMs, 128 s32 accumulators
//      a consumer thread, 3 ring stages beside the 64 KB tile), else 128
//      (M = 1500: 120 tiles of 128 columns take 0.0076 ms, 60 of 256
//      0.0126); at f32 128 (the 128 KB tile of 256 columns leaves 2
//      stages).
//      K10 takes a block an SM that walks the 720 tiles of 128 columns
//      (M = 3000), its tile beside the ring: the producer fills the ring
//      with the next tile's slabs while the consumers write this tile's
//      epilogue, whose tile waits only for the last tile's stores to have
//      read it. 0.0347 ms against 0.0405 for a block a tile with its tile
//      over the ring; 256-column tiles gain nothing.
//   PERF.md has the times (scripts/torch_qkv_variants.py): the GEMMs run at
//   about 40-45% of the int8 peak, as K2's do, and the quantization pass
//   (a round trip of 11.5 MB at bf16) is a third of K11 and a quarter of
//   K10.

#include "proj_wgmma.cuh"

namespace nwt {

// x (M, d) of type T; ln_g, ln_b, bq, bv (d,) f32; wqt, wkt, wvt: the
// K-major copies (d_out, d_in) of the int8 (d, d) weights, with (d,) f32
// column scales; d % 128 == 0; every pointer 16-byte aligned. Workspace:
// xq (M, d) int8, sx (M,) f32. Writes q, k, v (M, d) of type T.
template <typename T>
int encoder_qkv_int8(const void* x, const void* ln_g, const void* ln_b,
                     const void* wqt, const void* sq, const void* bq,
                     const void* wkt, const void* sk, const void* wvt,
                     const void* sv, const void* bv, void* q, void* k,
                     void* v, void* xq, void* sx, int M, int d,
                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || d % 128) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_ln_quant<T>(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_qkv_proj<T>(xq, sx, wqt, sq, bq, wkt, sk, wvt, sv, bv,
                                 q, k, v, 1.0f, M, d, st);
}

// x, a (M, d) of type T; wot: the K-major copy (d_out, d_in) of the int8
// (d, d) o weight, with (d,) f32 column scales so; bo (d,) f32;
// d % 128 == 0; every pointer 16-byte aligned. Workspace: aq (M, d) int8,
// sa (M,) f32. Writes out (M, d) of type T.
template <typename T>
int residual_o_int8(const void* x, const void* a, const void* wot,
                    const void* so, const void* bo, void* out, void* aq,
                    void* sa, int M, int d, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || d % 128) return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_ln_quant<T, false>(
      static_cast<const T*>(a), nullptr, nullptr, static_cast<int8_t*>(aq),
      static_cast<float*>(sa), M, d, st);
  if (e != cudaSuccess) return (int)e;
  const int bn = proj_bn<T>(true, M, d);
  ProjMaps maps = {};
  if (!g8_map(&maps.a, aq, d, M, d, 128) ||
      !g8_map(&maps.w[0], wot, d, d, d, bn) ||
      !proj_map<T>(&maps.out[0], out, d, M) ||
      !proj_map<T>(&maps.x, x, d, M))
    return (int)cudaErrorInvalidValue;
  const ProjArgs p = {static_cast<const float*>(sa),
                      {static_cast<const float*>(so), nullptr, nullptr},
                      {static_cast<const float*>(bo), nullptr, nullptr},
                      1.0f, M, d, 1};
  return (int)launch_proj_bn<T, true>(maps, p, bn, st);
}

}  // namespace nwt

using namespace nwt;

#define NWT_QKV_ARGS                                                        \
  const void *x, const void *ln_g, const void *ln_b, const void *wqt,       \
      const void *sq, const void *bq, const void *wkt, const void *sk,      \
      const void *wvt, const void *sv, const void *bv, void *q, void *k,    \
      void *v, void *xq, void *sx, int M, int d, void *stream
#define NWT_QKV_PASS                                                      \
  x, ln_g, ln_b, wqt, sq, bq, wkt, sk, wvt, sv, bv, q, k, v, xq, sx, M, d, \
      stream
#define NWT_RES_O_ARGS                                                      \
  const void *x, const void *a, const void *wot, const void *so,            \
      const void *bo, void *out, void *aq, void *sa, int M, int d,          \
      void *stream
#define NWT_RES_O_PASS x, a, wot, so, bo, out, aq, sa, M, d, stream

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
