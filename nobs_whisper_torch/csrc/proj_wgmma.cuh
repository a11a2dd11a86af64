// The int8 wgmma GEMM kernels, with their epilogues, that more than one
// source launches, on gemm_s8_wgmma.cuh's main loop (TMA ring, a producer
// warpgroup and two consumer warpgroups, int8 wgmma, K-major weights):
//
//   * proj_wgmma_kernel: projections of rows quantized per row (xq, sx),
//     (acc s_row) s_col (+ bias) (x q_scale) (+ x) in f32, written through
//     a 128-byte-swizzled shared-memory tile by TMA stores. K10's q/k/v and
//     K11's o with its residual (fused_qkv.cu); K1's q/k/v, and so K12's
//     (encoder_attention.cu): q pre-scaled by dh^-0.5 and rounded to bf16
//     (SCALE_Q), or, under the int8 scores, q written in f32 and unscaled
//     (its own output type TQ) beside bf16 k and v.
//   * mlp_fc2_kernel: out = x + b + the sum over K chunks of (acc_c s_rc)
//     s_col, each chunk's int32 sum flushed into an f32 one, chunks in
//     order. K2's and K8's fc2 and K12's MLP half (fused_mlp.cu: s_rc from
//     the chunk absmax bits that fc1 writes), and K1's fused o projection
//     (encoder_attention.cu: chunks of 128 columns, the head pairs, s_rc as
//     ln_quant_kernel writes it). Where a chunk is one slab (K1's), every
//     slab is flushed, and the flush (64 values a thread, 4 operations
//     each) costs about what the slab's products do: each slab runs as two
//     64-column halves, one half's sum flushed while the other half's
//     products run (PERF.md: 7% on that GEMM). The flush reads the tile's
//     column scales from shared memory (read from device memory at every
//     flush they made that GEMM 29% slower) and each chunk's row scales
//     one slab ahead.
//
// Both replace the port's first mma.sync kernels (common.cuh's
// qkv_gemm_kernel and fc2_gemm_kernel, frozen in tests/goldens/
// common_mma_sync.cuh): the int32 sums are exact and the epilogues keep
// their order, with the _rn intrinsics, so they give those kernels' bits.

#pragma once

#include <type_traits>

#include "common.cuh"
#include "gemm_s8_wgmma.cuh"

namespace nwt {

// ---------------------------------------------------------------------------
// proj_wgmma_kernel
// ---------------------------------------------------------------------------

// output tile widths by kernel and activation type, a width above 128
// taken only where its grid has K11_WIDE_TILES tiles or more; the ring's
// most stages
constexpr int K10_BN = 128, K10_BN_F32 = 128;
constexpr int K11_BN = 256, K11_BN_F32 = 128;
constexpr int K11_WIDE_TILES = 96;
constexpr int PROJ_MAX_STAGES = 6;

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

// the tile holds outputs of T, and q's of TQ: the larger of the two
template <typename T, typename TQ, int BN>
__host__ __device__ constexpr int proj_tile_bytes() {
  return ProjTile<T, BN>::BYTES > ProjTile<TQ, BN>::BYTES
             ? ProjTile<T, BN>::BYTES
             : ProjTile<TQ, BN>::BYTES;
}
template <typename T, typename TQ, int BN>
__host__ __device__ constexpr int proj_stages() {
  const int n = (G8Cfg::BUDGET - proj_tile_bytes<T, TQ, BN>()) /
                G8Tile<BN>::STAGE;
  return n > PROJ_MAX_STAGES ? PROJ_MAX_STAGES : n;
}
template <typename T, typename TQ, int BN>
__host__ __device__ constexpr int proj_smem() {   // + the alignment
  return proj_stages<T, TQ, BN>() * G8Tile<BN>::STAGE +
         proj_tile_bytes<T, TQ, BN>() + 1024;
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
  CUtensorMap out[3];   // outputs (M, d), boxes 128 bytes x 128 rows
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

// A consumer thread's share of the epilogue: (acc s_row) s_col (+ bias)
// (x q_scale where `scale`) (+ the residual, in place, RES) into the
// swizzled tile as O
template <typename O, int BN, bool RES>
__device__ __forceinline__ void proj_epilogue(const uint32_t (&acc)[BN / 2],
                                              uint8_t* tp, int rl, int lane,
                                              const float (&sr)[2],
                                              const float* s_col,
                                              const float* bias, bool scale,
                                              float q_scale) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 s = __ldg(reinterpret_cast<const float2*>(s_col + c));
    const float2 bb = bias ? __ldg(reinterpret_cast<const float2*>(bias + c))
                           : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      O* o = reinterpret_cast<O*>(tp + tile_off<O>(rl + 8 * h, c));
      float v0 = dequant((int)acc[i], sr[h], s.x);
      float v1 = dequant((int)acc[i + 1], sr[h], s.y);
      if (bias) {
        v0 = __fadd_rn(v0, bb.x);
        v1 = __fadd_rn(v1, bb.y);
      }
      if (scale) {
        v0 = __fmul_rn(v0, q_scale);
        v1 = __fmul_rn(v1, q_scale);
      }
      if (RES) {
        const float2 xv = load2(o);
        v0 = __fadd_rn(xv.x, v0);
        v1 = __fadd_rn(xv.y, v1);
      }
      store2(o, v0, v1);
    }
  }
}

// one thread: the tile of O to (n0, m0) through `map`, one TMA store a box
template <typename O, int BN>
__device__ __forceinline__ void proj_store(const CUtensorMap* map,
                                           uint32_t tile, int n0, int m0) {
  using PT = ProjTile<O, BN>;
#pragma unroll
  for (int b = 0; b < PT::BOXES; ++b)
    tma_store(map, tile + b * PT::BOX_BYTES, n0 + b * PT::CPB, m0);
  bulk_commit();
}

// The tiles: n_proj * d / BN column blocks (the projection first), the
// column block fastest, then ceil(M / 128) row blocks; block b takes
// tiles b, b + gridDim.x, ... RES: K11 (one projection, out = x + it),
// launched a block a tile, so that its residual tile is loaded once;
// else three, launched a block an SM. q (projection 0) is written as TQ,
// the others as T.
template <typename T, int BN, bool RES, bool SCALE_Q, typename TQ>
__global__ void __launch_bounds__(G8Cfg::THREADS, 1)
proj_wgmma_kernel(const __grid_constant__ ProjMaps maps, const ProjArgs p) {
  using L = G8Tile<BN>;
  using PT = ProjTile<T, BN>;
  constexpr int STAGES = proj_stages<T, TQ, BN>();
  constexpr bool QT = !std::is_same<T, TQ>::value;   // q of its own type
  static_assert(STAGES >= 2, "ring");
  static_assert(!(RES && QT), "K11 has no q");
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
        G8Cfg::PRODUCER_REGS));
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
      G8Cfg::CONSUMER_REGS));

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

    // the epilogue into the tile, in place over K11's residual; a block
    // that walks tiles first waits until the last tile's stores have read
    // it
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
    if (QT && z == 0)
      proj_epilogue<TQ, BN, false>(acc, tp, rl, lane, sr, s_col, bias,
                                   SCALE_Q, p.q_scale);
    else
      proj_epilogue<T, BN, RES>(acc, tp, rl, lane, sr, s_col, bias,
                                SCALE_Q && z == 0, p.q_scale);
    fence_proxy_async();   // the tile's writes, before the TMA reads them
    g8_bar<1>(256);
    if (threadIdx.x == 0) {
      if (QT && z == 0)
        proj_store<TQ, BN>(&maps.out[0], tile, n0, m0);
      else
        proj_store<T, BN>(&maps.out[z], tile, n0, m0);
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

// the tile width of the three projections (RES false) or K11 for M rows
// of type T at width d: the kernel's own where it divides d and, above
// 128, where its grid has K11_WIDE_TILES tiles or more (a grid of half the
// SMs runs the wide tiles slower than twice as many narrow ones), else 128
template <typename T>
inline int proj_bn(bool res, int M, int d) {
  const bool f32 = sizeof(T) == 4;
  const int bn =
      res ? (f32 ? K11_BN_F32 : K11_BN) : (f32 ? K10_BN_F32 : K10_BN);
  const int tiles = (res ? 1 : 3) * (d / bn) * ((M + 127) / 128);
  return d % bn == 0 && (bn == 128 || tiles >= K11_WIDE_TILES) ? bn : 128;
}

// the current card's SM count, for a block an SM, read once a device (one
// table for every library of the process that asks; 0 if unknown)
inline int sm_count() {
  static std::atomic<int> sms[MAX_DEVICES];
  const int dev = current_device();
  if (dev < 0 || dev >= MAX_DEVICES) return 0;
  int n = sms[dev].load(std::memory_order_relaxed);
  if (!n) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

template <typename T, int BN, bool RES, bool SCALE_Q = false,
          typename TQ = T>
inline cudaError_t launch_proj(const ProjMaps& maps, const ProjArgs& a,
                               cudaStream_t st) {
  constexpr int SMEM = proj_smem<T, TQ, BN>();
  auto kernel = proj_wgmma_kernel<T, BN, RES, SCALE_Q, TQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  const int n_tiles = a.n_proj * (a.d / BN) * ((a.M + 127) / 128);
  int grid = n_tiles;
  if (!RES) {
    if (!sm_count()) return cudaErrorInvalidDevice;
    grid = n_tiles < sm_count() ? n_tiles : sm_count();
  }
  kernel<<<grid, G8Cfg::THREADS, SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

template <typename T, bool RES, bool SCALE_Q = false, typename TQ = T>
inline cudaError_t launch_proj_bn(const ProjMaps& maps, const ProjArgs& a,
                                  int bn, cudaStream_t st) {
  return bn == 256 ? launch_proj<T, 256, RES, SCALE_Q, TQ>(maps, a, st)
                   : launch_proj<T, 128, RES, SCALE_Q, TQ>(maps, a, st);
}

// The three projections q, k, v of xq (M, d) int8 with its (M,) f32 row
// scales sx: wqt, wkt, wvt the K-major copies (d_out, d_in) of the int8
// (d, d) weights, with (d,) f32 column scales; bq, bv (d,) f32 (k has no
// bias). Writes k, v (M, d) of T and q (M, d) of TQ, q times q_scale after
// its bias where SCALE_Q. d % 128 == 0; every pointer 16-byte aligned.
template <typename T, bool SCALE_Q = false, typename TQ = T>
inline cudaError_t launch_qkv_proj(const void* xq, const void* sx,
                                   const void* wqt, const void* sq,
                                   const void* bq, const void* wkt,
                                   const void* sk, const void* wvt,
                                   const void* sv, const void* bv, void* q,
                                   void* k, void* v, float q_scale, int M,
                                   int d, cudaStream_t st) {
  const int bn = proj_bn<T>(false, M, d);
  ProjMaps maps = {};
  const void* wt[3] = {wqt, wkt, wvt};
  void* out[3] = {q, k, v};
  bool ok = g8_map(&maps.a, xq, d, M, d, 128) &&
            proj_map<TQ>(&maps.out[0], q, d, M);
  for (int i = 0; i < 3; ++i)
    ok = ok && g8_map(&maps.w[i], wt[i], d, d, d, bn) &&
         (i == 0 || proj_map<T>(&maps.out[i], out[i], d, M));
  if (!ok) return cudaErrorInvalidValue;
  const ProjArgs a = {static_cast<const float*>(sx),
                      {static_cast<const float*>(sq),
                       static_cast<const float*>(sk),
                       static_cast<const float*>(sv)},
                      {static_cast<const float*>(bq), nullptr,
                       static_cast<const float*>(bv)},
                      q_scale, M, d, 3};
  return launch_proj_bn<T, false, SCALE_Q, TQ>(maps, a, bn, st);
}

// ---------------------------------------------------------------------------
// mlp_fc2_kernel
// ---------------------------------------------------------------------------

// 128 x 128 tiles (the f32 sum beside the int32 one leaves no registers
// for wider tiles)
constexpr int FC2_BN = 128;

// the ring of a kernel with 128 x bn tiles: 5 stages of 36 KB (bn 160),
// 6 of 32 KB (128)
__host__ __device__ constexpr int ring_stages(int bn) {
  return bn == 160 ? 5 : 6;
}
__host__ __device__ constexpr int ring_smem(int bn) {   // + the alignment
  return ring_stages(bn) * (128 + bn) * G8_BK + 1024;
}
constexpr int BAR_CONSUMERS = 1;   // named barrier of the 256 MMA threads

template <typename T>
struct MlpFC2Args {
  const unsigned* amax;  // (M, F / block_f) float bits of each chunk
                         // absmax, or null:
  const float* sa;       // (M, F / block_f) the chunk scales
  const float* s2;       // (d,) column scales
  const float* b2;       // (d,)
  const T* x;            // residual (M, d)
  T* out;                // (M, d)
  int M, d, F, block_f;
};

// facc += (acc s_rc) s2 over a consumer thread's sum of N columns, the
// tile's columns [N half, N half + N): s2 the tile's column scales (in
// shared memory). They are read 32 columns at a time (a compiler barrier
// between the groups), so that at most 8 of them are live beside the
// sums.
template <int N>
__device__ __forceinline__ void fc2_flush(float (&facc)[FC2_BN / 2],
                                          const uint32_t (&acc)[N / 2],
                                          const float* s2,
                                          const float (&sa)[2], int lane,
                                          int half = 0) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (j % 4 == 0) asm volatile("" ::: "memory");
    const float2 s = *reinterpret_cast<const float2*>(
        s2 + N * half + 8 * j + 2 * (lane & 3));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, f = N / 2 * half + i;
      facc[f] = __fadd_rn(facc[f], dequant((int)acc[i], sa[h], s.x));
      facc[f + 1] =
          __fadd_rn(facc[f + 1], dequant((int)acc[i + 1], sa[h], s.y));
    }
  }
}

// ta maps aq (M, F), tb maps w2t (d, F), both in boxes of 128 rows. Grid
// (d / 128, ceil(M / 128)). PP: a chunk is one slab (block_f == G8_BK),
// its products in two halves.
template <typename T, bool PP>
__global__ void __launch_bounds__(G8Cfg::THREADS, 1)
mlp_fc2_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb,
               const MlpFC2Args<T> p) {
  using L = G8Tile<FC2_BN>;
  constexpr int STAGES = ring_stages(FC2_BN);
  extern __shared__ uint8_t fc2_smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];
  __shared__ __align__(8) float s2s[FC2_BN];   // the tile's column scales
  const uint32_t ring = (smem_u32(fc2_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int n0 = blockIdx.x * FC2_BN, m0 = blockIdx.y * 128;
  const int n_slabs = p.F / G8_BK;
  if (threadIdx.x == 0) g8_init_bars<STAGES>(full, empty);
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G8Cfg::PRODUCER_REGS));
    if (threadIdx.x == L::PRODUCER)
      g8_produce<FC2_BN, STAGES>(&ta, &tb, ring, full, empty, n_slabs, m0,
                                 n0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      G8Cfg::CONSUMER_REGS));

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);   // rows rl, rl + 8
  // every flush reads the column scales: from shared memory, not L2
  if (threadIdx.x < FC2_BN) s2s[threadIdx.x] = p.s2[n0 + threadIdx.x];
  bool live[2];
  float facc[L::NACC];   // x + b2, then each chunk's (acc s_rc) s2 added
#pragma unroll
  for (int h = 0; h < 2; ++h) live[h] = m0 + rl + 8 * h < p.M;
#pragma unroll
  for (int j = 0; j < FC2_BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    const float2 b = *reinterpret_cast<const float2*>(p.b2 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 x = make_float2(0.f, 0.f);
      if (live[h]) x = load2(p.x + (size_t)(m0 + rl + 8 * h) * p.d + c);
      facc[4 * j + 2 * h] = live[h] ? __fadd_rn(x.x, b.x) : 0.f;
      facc[4 * j + 2 * h + 1] = live[h] ? __fadd_rn(x.y, b.y) : 0.f;
    }
  }

  const int n_chunks = p.F / p.block_f;
  const float* s2 = s2s;
  g8_bar<BAR_CONSUMERS>(256);   // s2s is written
  // the two rows' scales of chunk c (a dead row's read at row 0: no
  // branch while products run)
  auto scales = [&](int c, float (&sa)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = live[h] ? m0 + rl + 8 * h : 0;
      const float v = p.amax ? chunk_scale(p.amax, r, n_chunks, c)
                             : p.sa[(size_t)r * n_chunks + c];
      sa[h] = live[h] ? v : 0.f;
    }
  };
  // slab s has been read: its stage goes back to the producer
  auto free_slab = [&](int s) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * (s % STAGES));
  };
  // a chunk's scales are read when its first slab is issued and used at
  // its flush: the load's latency runs beside the products
  float sa[2];
  if constexpr (PP) {
    // slab s's products as its low half then its high half (one commit
    // group each); the low half's sum is flushed while the high half
    // runs, the high half's while slab s + 1's low half runs
    uint32_t lo[FC2_BN / 4], hi[FC2_BN / 4];
#pragma unroll
    for (int i = 0; i < FC2_BN / 4; ++i) lo[i] = hi[i] = 0;
    auto issue = [&](uint32_t (&acc)[FC2_BN / 4], int s, int half) {
      const uint32_t stage = ring + (s % STAGES) * L::STAGE;
      if (half == 0) mbar_wait(full + 8 * (s % STAGES), (s / STAGES) & 1);
      g8_mma_half(acc, stage + wg * 64 * G8_BK, stage + L::A_BYTES, half);
    };
    issue(lo, 0, 0);
    issue(hi, 0, 1);
    scales(0, sa);
    for (int it = 0; it < n_slabs - 1; ++it) {
      float next[2];
      scales(it + 1, next);
      wgmma_wait<1>();   // slab it's low half is done
      fence_regs(lo);
      fc2_flush<FC2_BN / 2>(facc, lo, s2, sa, lane, 0);
      issue(lo, it + 1, 0);
      wgmma_wait<1>();   // slab it's high half is done
      free_slab(it);
      fence_regs(hi);
      fc2_flush<FC2_BN / 2>(facc, hi, s2, sa, lane, 1);
      issue(hi, it + 1, 1);
      sa[0] = next[0];
      sa[1] = next[1];
    }
    wgmma_wait<1>();
    fence_regs(lo);
    fc2_flush<FC2_BN / 2>(facc, lo, s2, sa, lane, 0);
    wgmma_wait<0>();
    fence_regs(hi);
    fc2_flush<FC2_BN / 2>(facc, hi, s2, sa, lane, 1);
  } else {
    uint32_t acc[L::NACC];
#pragma unroll
    for (int i = 0; i < L::NACC; ++i) acc[i] = 0;
    const int per_chunk = p.block_f / G8_BK;
    for (int it = 0; it < n_slabs; ++it) {
      const int kc = it % per_chunk;
      g8_mma_slab<FC2_BN, STAGES>(acc, ring, full, it, wg, kc == 0);
      if (kc == 0) scales(it / per_chunk, sa);
      if (kc < per_chunk - 1) {
        wgmma_wait<1>();   // slab it - 1's group has read its stage
        if (it > 0) free_slab(it - 1);
      } else {   // chunk boundary: acc s_rc s2 into the f32 sum
        wgmma_wait<0>();
        fence_regs(acc);
        if (it > 0) free_slab(it - 1);
        fc2_flush<FC2_BN>(facc, acc, s2, sa, lane);
      }
    }
  }

  // out through a tile over the ring (both warpgroups have read every
  // stage once past this barrier), then 16-byte stores of whole rows
  g8_bar<BAR_CONSUMERS>(256);
  constexpr int LD = FC2_BN + 8;   // rows 16 / 32 bytes apart from a bank
  static_assert(128 * LD * sizeof(T) <= STAGES * L::STAGE, "tile");
  T* tile = reinterpret_cast<T*>(fc2_smem + (ring - smem_u32(fc2_smem)));
#pragma unroll
  for (int j = 0; j < FC2_BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      store2(tile + (rl + 8 * h) * LD + 8 * j + 2 * (lane & 3),
             facc[4 * j + 2 * h], facc[4 * j + 2 * h + 1]);
  g8_bar<BAR_CONSUMERS>(256);
  constexpr int VEC = 16 / sizeof(T), CPR = FC2_BN / VEC;
  for (int k = threadIdx.x; k < 128 * CPR; k += 256) {
    const int rr = k / CPR, cc = k % CPR, r = m0 + rr;
    if (r < p.M)
      *reinterpret_cast<int4*>(p.out + (size_t)r * p.d + n0 + VEC * cc) =
          *reinterpret_cast<const int4*>(tile + rr * LD + VEC * cc);
  }
}

// ta maps aq (M, F), tb maps w2t (d, F) (g8_map, boxes of 128 and FC2_BN
// rows); the kernel's attributes at every launch: no per-library state
// (K12's library includes fused_mlp.cu beside encoder_attention.cu, and
// both launch this kernel)
template <typename T>
inline cudaError_t launch_fc2(const CUtensorMap& ta, const CUtensorMap& tb,
                              const MlpFC2Args<T>& a, cudaStream_t st) {
  auto kernel = a.block_f == G8_BK ? mlp_fc2_kernel<T, true>
                                   : mlp_fc2_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_smem(FC2_BN));
  if (e != cudaSuccess) return e;
  kernel<<<dim3(a.d / FC2_BN, (a.M + 127) / 128), G8Cfg::THREADS,
           ring_smem(FC2_BN), st>>>(ta, tb, a);
  return cudaGetLastError();
}

}  // namespace nwt
