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
//   2. proj_wgmma_kernel: the projections on gemm_s8_wgmma.cuh's TMA ring
//      and int8 wgmma, the weights as their K-major copies (d_out, d_in),
//      made once per weight by the wrapper (ops/quant.py::k_major). A
//      block an SM: 384 threads, the third warpgroup the producer,
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
//   K10. The kernel is templated on K1's q pre-scale (SCALE_Q: q times
//   q_scale after its bias, K1's dh^-0.5), off for K10, so that K1's
//   projections can take it (K1 also writes q in f32 for its int8 scores);
//   K1 and K12 still call common.cuh's launch_qkv_gemm.

#include "common.cuh"
#include "gemm_s8_wgmma.cuh"

namespace nwt {

// output tile widths by kernel and activation type, a width above 128
// taken only where its grid has K11_WIDE_TILES tiles or more; the ring's
// most stages
constexpr int K10_BN = 128, K10_BN_F32 = 128;
constexpr int K11_BN = 256, K11_BN_F32 = 128;
constexpr int K11_WIDE_TILES = 96;
constexpr int PROJ_MAX_STAGES = 6;

struct ProjCfg {
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "regs");
  // dynamic shared memory for the ring and the tile beside it: the
  // block's 227 KB less the alignment slack and the static mbarriers
  static constexpr int BUDGET = 232448 - 2048;
};

// the 128 x BN output (and residual) tile of T: boxes of 128 bytes x 128
// rows under the 128-byte swizzle, as a TMA map of T with that box moves
// them
template <typename T, int BN>
struct ProjTile {
  static constexpr int CPB = 128 / sizeof(T);   // columns a box
  static constexpr int BOXES = BN / CPB;
  static constexpr int BOX_BYTES = 128 * 128;
  static constexpr int BYTES = BOXES * BOX_BYTES;
};

template <typename T, int BN>
__host__ __device__ constexpr int proj_stages() {
  return (ProjCfg::BUDGET - ProjTile<T, BN>::BYTES) / G8Tile<BN>::STAGE >
                 PROJ_MAX_STAGES
             ? PROJ_MAX_STAGES
             : (ProjCfg::BUDGET - ProjTile<T, BN>::BYTES) / G8Tile<BN>::STAGE;
}
template <typename T, int BN>
__host__ __device__ constexpr int proj_smem() {   // + the alignment
  return proj_stages<T, BN>() * G8Tile<BN>::STAGE + ProjTile<T, BN>::BYTES +
         1024;
}

// the byte offset of (row r, column c) in the swizzled tile
template <typename T>
__device__ __forceinline__ uint32_t tile_off(int r, int c) {
  constexpr int CPB = 128 / sizeof(T);
  const int byte = (c % CPB) * (int)sizeof(T);
  return (c / CPB) * 16384 + r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) +
         (byte & 15);
}

struct alignas(64) ProjMaps {
  CUtensorMap a;        // xq (M, d) int8, boxes 128 bytes x 128 rows
  CUtensorMap w[3];     // K-major weights (d_out, d_in) int8, 128 B x BN
  CUtensorMap out[3];   // outputs (M, d) of T, boxes 128 bytes x 128 rows
  CUtensorMap x;        // K11: the residual (M, d) of T, as out
};

struct ProjArgs {
  const float* sx;       // (M,) row scales of xq
  const float* s[3];     // (d,) column scales
  const float* bias[3];  // (d,), or null (k)
  float q_scale;         // SCALE_Q: q times this after its bias
  int M, d, n_proj;
};

// a[z] by selects: a dynamic index into a kernel parameter's array would
// copy the parameter to local memory
template <typename P>
__device__ __forceinline__ P pick3(const P (&a)[3], int z) {
  return z == 0 ? a[0] : z == 1 ? a[1] : a[2];
}

// The tiles: n_proj * d / BN column blocks (the projection first), the
// column block fastest, then ceil(M / 128) row blocks; block b takes
// tiles b, b + gridDim.x, ... RES: K11 (one projection, out = x + it),
// launched a block a tile, so that its residual tile is loaded once;
// else K10's three, launched a block an SM.
template <typename T, int BN, bool RES, bool SCALE_Q>
__global__ void __launch_bounds__(ProjCfg::THREADS, 1)
proj_wgmma_kernel(const __grid_constant__ ProjMaps maps, const ProjArgs p) {
  using L = G8Tile<BN>;
  using PT = ProjTile<T, BN>;
  constexpr int STAGES = proj_stages<T, BN>();
  static_assert(STAGES >= 2, "ring");
  extern __shared__ uint8_t proj_smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];   // full, empty, x
  const uint32_t base = smem_u32(proj_smem_raw);
  const uint32_t ring = (base + 1023) & ~1023u;
  const uint32_t tile = ring + STAGES * L::STAGE;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES,
                 xbar = empty + 8 * STAGES;
  const int nb = p.d / BN, n_col = p.n_proj * nb;
  const int n_tiles = n_col * ((p.M + 127) / 128);
  const int n_slabs = p.d / G8_BK;
  if (threadIdx.x == 0) {
    if (RES) mbar_init(xbar, 1);
    g8_init_bars<STAGES>(full, empty);
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        ProjCfg::PRODUCER_REGS));
    if (threadIdx.x == L::PRODUCER) {
      int g = 0;   // the ring's next slab
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, g += n_slabs) {
        const int col = t % n_col, z = col / nb;
        const int n0 = (col % nb) * BN, m0 = (t / n_col) * 128;
        g8_produce<BN, STAGES>(&maps.a, &maps.w[z], ring, full, empty,
                               n_slabs, m0, n0, g);
        if (RES) {   // the residual tile, after the ring's loads
          mbar_expect_tx(xbar, PT::BYTES);
#pragma unroll
          for (int b = 0; b < PT::BOXES; ++b)
            tma_load(tile + b * PT::BOX_BYTES, &maps.x, n0 + b * PT::CPB, m0,
                     xbar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      ProjCfg::CONSUMER_REGS));

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);   // rows rl, rl + 8
  uint8_t* tp = proj_smem_raw + (tile - base);
  uint32_t acc[L::NACC];
#pragma unroll
  for (int i = 0; i < L::NACC; ++i) acc[i] = 0;
  int g = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, g += n_slabs) {
    const int col = t % n_col, z = col / nb;
    const int n0 = (col % nb) * BN, m0 = (t / n_col) * 128;
    for (int it = 0; it < n_slabs; ++it) {
      // the tile's first slab overwrites the sum (scale-d = 0)
      g8_mma_slab<BN, STAGES>(acc, ring, full, g + it, wg, it == 0);
      wgmma_wait<1>();   // slab it - 1's group has read its stage
      if (it > 0 && (threadIdx.x & 127) == 0)
        mbar_arrive(empty + 8 * ((g + it - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if ((threadIdx.x & 127) == 0)
      mbar_arrive(empty + 8 * ((g + n_slabs - 1) % STAGES));

    // (acc s_row) s_col (+ bias) (x q_scale) (+ x) into the tile, in place
    // over K11's residual; K10's block first waits until the last tile's
    // stores have read it.
    float sr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sr[h] = m0 + rl + 8 * h < p.M ? p.sx[m0 + rl + 8 * h] : 0.f;
    const float* s_col = pick3(p.s, z) + n0;
    const float* bias = pick3(p.bias, z);
    if (bias) bias += n0;
    if (RES) {
      mbar_wait(xbar, 0);
    } else {
      if (threadIdx.x == 0) bulk_wait_read<0>();
      g8_bar<1>(256);
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 s = __ldg(reinterpret_cast<const float2*>(s_col + c));
      const float2 bb =
          bias ? __ldg(reinterpret_cast<const float2*>(bias + c))
               : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h;
        T* o = reinterpret_cast<T*>(tp + tile_off<T>(rl + 8 * h, c));
        float v0 = dequant((int)acc[i], sr[h], s.x);
        float v1 = dequant((int)acc[i + 1], sr[h], s.y);
        if (bias) {
          v0 = __fadd_rn(v0, bb.x);
          v1 = __fadd_rn(v1, bb.y);
        }
        if (SCALE_Q && z == 0) {
          v0 = __fmul_rn(v0, p.q_scale);
          v1 = __fmul_rn(v1, p.q_scale);
        }
        if (RES) {
          const float2 xv = load2(o);
          v0 = __fadd_rn(xv.x, v0);
          v1 = __fadd_rn(xv.y, v1);
        }
        store2(o, v0, v1);
      }
    }
    fence_proxy_async();   // the tile's writes, before the TMA reads them
    g8_bar<1>(256);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int b = 0; b < PT::BOXES; ++b)
        tma_store(&maps.out[z], tile + b * PT::BOX_BYTES, n0 + b * PT::CPB,
                  m0);
      bulk_commit();
    }
  }
  // the tile stays until the stores have read it
  if (threadIdx.x == 0) bulk_wait_read<0>();
}

// a 2-D map of T (rows of `cols`, dense) in boxes of 128 bytes x 128 rows
// under the 128-byte swizzle, zero fill
template <typename T>
inline bool proj_map(CUtensorMap* map, const void* z, int cols, int rows) {
  EncodeTiledFn enc = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / sizeof(T)), 128};
  const cuuint32_t unit[2] = {1, 1};
  return enc &&
         enc(map,
             sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(z), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tile width of K10 (RES false) or K11 for M rows of type T at width
// d: the kernel's own where it divides d and, above 128, where its grid
// has K11_WIDE_TILES tiles or more (a grid of half the SMs runs the wide
// tiles slower than twice as many narrow ones), else 128
template <typename T>
inline int proj_bn(bool res, int M, int d) {
  const bool f32 = sizeof(T) == 4;
  const int bn =
      res ? (f32 ? K11_BN_F32 : K11_BN) : (f32 ? K10_BN_F32 : K10_BN);
  const int tiles = (res ? 1 : 3) * (d / bn) * ((M + 127) / 128);
  return d % bn == 0 && (bn == 128 || tiles >= K11_WIDE_TILES) ? bn : 128;
}

// the card's SM count, for a block an SM
inline int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename T, int BN, bool RES>
inline cudaError_t launch_proj(const ProjMaps& maps, const ProjArgs& a,
                               cudaStream_t st) {
  constexpr int SMEM = proj_smem<T, BN>();
  auto kernel = proj_wgmma_kernel<T, BN, RES, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const int n_tiles = a.n_proj * (a.d / BN) * ((a.M + 127) / 128);
  int grid = n_tiles;
  if (!RES) {
    if (!sm_count()) return cudaErrorInvalidDevice;
    grid = n_tiles < sm_count() ? n_tiles : sm_count();
  }
  kernel<<<grid, ProjCfg::THREADS, SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, bool RES>
inline cudaError_t launch_proj_bn(const ProjMaps& maps, const ProjArgs& a,
                                  int bn, cudaStream_t st) {
  return bn == 256 ? launch_proj<T, 256, RES>(maps, a, st)
                   : launch_proj<T, 128, RES>(maps, a, st);
}

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
  const int bn = proj_bn<T>(false, M, d);
  ProjMaps maps = {};
  const void* wt[3] = {wqt, wkt, wvt};
  void* out[3] = {q, k, v};
  bool ok = g8_map(&maps.a, xq, d, M, d, 128);
  for (int i = 0; i < 3; ++i)
    ok = ok && g8_map(&maps.w[i], wt[i], d, d, d, bn) &&
         proj_map<T>(&maps.out[i], out[i], d, M);
  if (!ok) return (int)cudaErrorInvalidValue;
  const ProjArgs a = {static_cast<const float*>(sx),
                      {static_cast<const float*>(sq),
                       static_cast<const float*>(sk),
                       static_cast<const float*>(sv)},
                      {static_cast<const float*>(bq), nullptr,
                       static_cast<const float*>(bv)},
                      1.0f, M, d, 3};
  return (int)launch_proj_bn<T, false>(maps, a, bn, st);
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
