// The grouped SwiGLU expert FFN of ops/moe.py: Uni-MoE-2.0-Omni's routed
// experts (4 of width 18,944 at d 3584) and shared experts (2 of 2,368),
// bf16 weights and activations, f32 sums, on Hopper (sm_90a).
//
// It replaces no TPU kernel: the JAX package serves Whisper, which has no
// expert layer. It was added for the speech LM's MoE FFN, whose routed
// experts hold 91% of a decode step's bytes and take ~84% of a prefill
// token's operations.
//
// The caller (ops/moe.py::expert_ffn) has sorted the (token, slot) pairs
// by expert into a plan: `rows`, the pair ids in that order with each
// expert's run padded to a multiple of 128 (a padding slot holds
// n_pairs), and `block_expert`, each 128-row block's expert (-1 past the
// last run); and gathered x's rows into that order (xs). Two launches:
//
//   * moe_gate_up_kernel: h = silu(xs Wg) * (xs Wu), rounded to bf16, in
//     the plan's order. A block's tile is 128 rows x 128 columns of h: it
//     multiplies by 256 columns of w13 (E, d, 2F), the 128 gate columns and
//     the 128 up columns of the same outputs, as one N = 256 product, so
//     that the epilogue holds each output's gate and up sums in one thread
//     (gate column c at accumulator j, its up column at j + 16).
//   * moe_down_kernel: h Wd (w2 (E, F, d)) times the pair's weight, in f32
//     at the pair's own row of y (splits, n_pairs, d): the scatter needs no
//     atomics, and the caller sums a token's slots and the K splits in a
//     fixed order, so the layer's output is the same from run to run. A
//     block's tile is 128 rows x 256 columns over one K split.
//
// Both on one main loop, as conv_stem.cu's conv2 (K13): 384 threads, two
// consumer warpgroups of 64 rows and a producer warpgroup whose first
// thread issues the TMA loads (setmaxnreg moving registers to the
// consumers); a ring of 4 stages of one 64-wide K slab each: the A tile
// (128 rows, K-major, 128-byte swizzle) and four 64 x 64 boxes of the
// weight as stored (N contiguous), read by wgmma.m64n256k16 as an
// MN-major operand (the transpose bit; the leading byte offset steps from
// box to box). Weights are addressed as 3-D maps (N, K, E): a box past the
// expert's K or N reads as zero. The epilogue goes through a tile over the
// ring, then 16-byte stores.
//
// The grid is the batch's worst case, sized from the token count alone (so
// a decode step's launches are the same at every step and the step
// captures as one CUDA graph): a block whose row block has no expert exits
// at once. Blocks walk the tiles in groups of MOE_GROUP_M row blocks, the
// row block fastest, so that the blocks resident at once share a few
// weight slabs and row blocks in L2.
//
// What bounds it on an H100: at decode (32 tokens, <= 64 pairs) the
// weights' bytes, 407 MB an expert hit at 3.35 TB/s; the down projection
// then has 14 column tiles an expert, so its K is split (`splits`) until
// the grid fills the SMs. At prefill (~11 k tokens, two slots each) the
// tensor cores: 407 MFLOP a pair at 989 TFLOP/s.

#include "common.cuh"
#include "gemm_s8_wgmma.cuh"   // G8Cfg's block, g8_init_bars, g8_bar

namespace nwt {

constexpr int MOE_BM = 128;      // rows a tile: two consumer warpgroups
constexpr int MOE_BN = 256;      // accumulator columns a tile
constexpr int MOE_BK = 64;       // bf16 K a slab: one 128-byte row
constexpr int MOE_STAGES = 4;
constexpr int MOE_GROUP_M = 8;   // row blocks a raster group
constexpr int MOE_A_BYTES = MOE_BM * MOE_BK * 2;             // 16 KB
constexpr int MOE_B_BOX = MOE_BK * 64 * 2;                   // 8 KB
constexpr int MOE_STAGE = MOE_A_BYTES + (MOE_BN / 64) * MOE_B_BOX;
constexpr int MOE_SMEM = MOE_STAGES * MOE_STAGE + 1024;     // + alignment
constexpr int MOE_NACC = MOE_BN / 2;                         // f32 a thread
constexpr int MOE_BAR = 1;       // named barrier of the 256 MMA threads
// epilogue tiles over the ring, rows padded against bank conflicts
constexpr int MOE_LD_H = MOE_BN / 2 + 8;   // bf16 h: 128 columns
constexpr int MOE_LD_Y = MOE_BN + 4;       // f32 y: 256 columns
static_assert(MOE_BM * MOE_LD_Y * 4 <= MOE_STAGES * MOE_STAGE, "tile");
static_assert(MOE_STAGE % 1024 == 0, "1024-byte aligned stages");

struct MoeArgs {
  const int* rows;          // (n_mb * 128,) pair ids in the plan's order
  const int* block_expert;  // (n_mb,)
  const float* wt;          // (n_pairs,) the pairs' weights (down)
  void* out;                // h (n_mb * 128, F) bf16 or y (splits, n_pairs, d) f32
  int n_pairs, n_mb, n_col; // row blocks, column tiles
  int n_slabs, per_split;   // K slabs in all and a split
  int N;                    // output columns: F (gate_up) or d (down)
};

#define MOE_R128                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                    \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "          \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "  \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "    \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define MOE_F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define MOE_F128                                                          \
  MOE_F8(0), MOE_F8(8), MOE_F8(16), MOE_F8(24), MOE_F8(32), MOE_F8(40),   \
      MOE_F8(48), MOE_F8(56), MOE_F8(64), MOE_F8(72), MOE_F8(80),         \
      MOE_F8(88), MOE_F8(96), MOE_F8(104), MOE_F8(112), MOE_F8(120)

// D (64 x 256 f32) += A (64 x 16, K-major) B (16 x 256, MN-major: the
// transpose bit), both bf16 in shared memory
__device__ __forceinline__ void wgmma_moe(float (&d)[MOE_NACC], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" MOE_R128 "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MOE_F128
      : "l"(da), "l"(db), "n"(1));
}

// tile t of the grid's walk -> (row block, column tile): groups of
// MOE_GROUP_M row blocks, the row block fastest within a group
__device__ __forceinline__ void moe_tile(int t, int n_mb, int n_col, int& mb,
                                         int& col) {
  const int per = MOE_GROUP_M * n_col;
  const int first = (t / per) * MOE_GROUP_M;
  const int gm = min(MOE_GROUP_M, n_mb - first);
  const int r = t % per;
  mb = first + r % gm;
  col = r / gm;
}

// The block's tile: ta maps A (rows, K) bf16 in boxes of 64 x 128 rows, tb
// the weights (N, K, E) in boxes of 64 x 64 x 1. GU: gate and up (w13,
// whose up half starts at column p.N), else down with K split p.per_split
// slabs at a time (blockIdx.x = tile * splits + split).
template <bool GU>
__device__ __forceinline__ void moe_body(const CUtensorMap* ta,
                                         const CUtensorMap* tb,
                                         const MoeArgs& p) {
  const int splits = GU ? 1 : (p.n_slabs + p.per_split - 1) / p.per_split;
  const int split = blockIdx.x % splits;
  int mb, col;
  moe_tile(blockIdx.x / splits, p.n_mb, p.n_col, mb, col);
  const int e = p.block_expert[mb];
  if (e < 0) return;   // past the last run: the whole block, at once
  extern __shared__ uint8_t moe_smem[];
  __shared__ __align__(8) uint64_t bars[2 * MOE_STAGES];   // full, empty
  const uint32_t ring = (smem_u32(moe_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * MOE_STAGES;
  const int m0 = mb * MOE_BM;
  const int n0 = col * (GU ? MOE_BN / 2 : MOE_BN);
  const int k0 = GU ? 0 : split * p.per_split;
  const int n_k = GU ? p.n_slabs : min(p.per_split, p.n_slabs - k0);
  if (threadIdx.x == 0) g8_init_bars<MOE_STAGES>(full, empty);
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G8Cfg::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % MOE_STAGES, k = (k0 + it) * MOE_BK;
        if (it >= MOE_STAGES)
          mbar_wait(empty + 8 * s, ((it / MOE_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, MOE_STAGE);
        const uint32_t dst = ring + s * MOE_STAGE;
        tma_load(dst, ta, k, m0, full + 8 * s);
#pragma unroll
        for (int i = 0; i < MOE_BN / 64; ++i) {
          // GU: boxes 0, 1 the gate columns, 2, 3 the same up columns
          const int c = GU ? (i < 2 ? n0 + 64 * i : p.N + n0 + 64 * (i - 2))
                           : n0 + 64 * i;
          tma_load_3d(dst + MOE_A_BYTES + i * MOE_B_BOX, tb, c, k, e,
                      full + 8 * s);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      G8Cfg::CONSUMER_REGS));

  // zeroed here and written only by wgmma after: ptxas serializes every
  // wgmma (C7515) if another instruction defines an accumulator in flight
  float acc[MOE_NACC];
#pragma unroll
  for (int i = 0; i < MOE_NACC; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % MOE_STAGES;
    mbar_wait(full + 8 * s, (it / MOE_STAGES) & 1);
    const uint32_t a = ring + s * MOE_STAGE + wg * (MOE_A_BYTES / 2);
    const uint32_t b = ring + s * MOE_STAGE + MOE_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MOE_BK / 16; ++kk)   // 16 of K a step
      wgmma_moe(acc, smem_desc(a + kk * 32, 1024, 1),
                smem_desc(b + kk * 16 * 128, 1024, 1, MOE_B_BOX));
    wgmma_commit();
    wgmma_wait<1>();   // slab it - 1's group has read its stage
    if (it > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + 8 * ((it - 1) % MOE_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // the epilogue through a tile over the ring, once both warpgroups have
  // read their last slab; accumulator 4 j + 2 h + e is row rl + 8 h,
  // column 8 j + 2 (lane % 4) + e
  g8_bar<MOE_BAR>(256);
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);
  uint8_t* tile = moe_smem + (ring - smem_u32(moe_smem));
  if constexpr (GU) {
    bf16* t = reinterpret_cast<bf16*>(tile);
#pragma unroll
    for (int j = 0; j < MOE_BN / 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float g = acc[4 * j + 2 * h + q];
          const float u = acc[4 * (j + MOE_BN / 16) + 2 * h + q];
          v[q] = g / (1.f + expf(-g)) * u;
        }
        store2(t + (rl + 8 * h) * MOE_LD_H + 8 * j + 2 * (lane & 3), v[0],
               v[1]);
      }
    g8_bar<MOE_BAR>(256);
    // 16 columns a row of 8 bf16 each; h has every row of the plan
    bf16* hp = static_cast<bf16*>(p.out);
    constexpr int CPR = MOE_BN / 2 / 8;
    for (int k = threadIdx.x; k < MOE_BM * CPR; k += 256) {
      const int rr = k / CPR, c = n0 + 8 * (k % CPR);
      if (c < p.N)
        *reinterpret_cast<int4*>(hp + (size_t)(m0 + rr) * p.N + c) =
            *reinterpret_cast<const int4*>(t + rr * MOE_LD_H + 8 * (k % CPR));
    }
  } else {
    float* t = reinterpret_cast<float*>(tile);
#pragma unroll
    for (int j = 0; j < MOE_BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store2(t + (rl + 8 * h) * MOE_LD_Y + 8 * j + 2 * (lane & 3),
               acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    g8_bar<MOE_BAR>(256);
    // each row to its pair's row of y, times the pair's weight; a padding
    // slot is not written
    float* yp = static_cast<float*>(p.out) + (size_t)split * p.n_pairs * p.N;
    constexpr int CPR = MOE_BN / 4;
    for (int k = threadIdx.x; k < MOE_BM * CPR; k += 256) {
      const int rr = k / CPR, c = n0 + 4 * (k % CPR);
      const int pair = p.rows[m0 + rr];
      if (pair < p.n_pairs && c < p.N) {
        const float w = p.wt[pair];
        float4 v = *reinterpret_cast<const float4*>(t + rr * MOE_LD_Y +
                                                    4 * (k % CPR));
        v.x *= w, v.y *= w, v.z *= w, v.w *= w;
        *reinterpret_cast<float4*>(yp + (size_t)pair * p.N + c) = v;
      }
    }
  }
}

}  // namespace nwt

using namespace nwt;

// unmangled, so that a device trace names them moe_*
extern "C" __global__ void __launch_bounds__(G8Cfg::THREADS, 1)
moe_gate_up_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, const MoeArgs p) {
  moe_body<true>(&ta, &tb, p);
}

extern "C" __global__ void __launch_bounds__(G8Cfg::THREADS, 1)
moe_down_kernel(const __grid_constant__ CUtensorMap ta,
                const __grid_constant__ CUtensorMap tb, const MoeArgs p) {
  moe_body<false>(&ta, &tb, p);
}

namespace {

// a bf16 tensor map of `rank` dims (dims[0] contiguous; strides in bytes
// of dims 1..rank-1), 128-byte swizzle, zero fill
bool moe_map(CUtensorMap* map, const void* z, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
  EncodeTiledFn enc = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(z), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (rows, K) bf16 in boxes of 64 x 128 rows, and weights (E, K, N) as a
// (N, K, E) map in boxes of 64 x 64 x 1
bool moe_maps(CUtensorMap* ta, CUtensorMap* tb, const void* a, int rows,
              int K, const void* w, int E, int N) {
  const cuuint64_t es = 2;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t a_str[1] = {K * es};
  const cuuint32_t a_box[2] = {MOE_BK, MOE_BM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t w_str[2] = {N * es, (cuuint64_t)K * N * es};
  const cuuint32_t w_box[3] = {64, MOE_BK, 1};
  return moe_map(ta, a, 2, a_dims, a_str, a_box) &&
         moe_map(tb, w, 3, w_dims, w_str, w_box);
}

DeviceFlags moe_attrs;

}  // namespace

// xs (n_mb * 128, d) bf16: x's rows in the plan's order; w13 (E, d, 2F),
// w2 (E, F, d) bf16 as stored; rows (n_mb * 128,), block_expert (n_mb,)
// int32; wt (n_pairs,) f32. Workspace h (n_mb * 128, F) bf16. Writes y
// (splits, n_pairs, d) f32 at the routed pairs' rows only (the caller
// zeroes it), splits = ceil(F / 64 / per_split). d and F multiples of 64;
// every pointer 16-byte aligned.
extern "C" int nwt_moe_expert_ffn(const void* xs, const void* w13,
                                  const void* w2, const void* rows,
                                  const void* block_expert, const void* wt,
                                  void* h, void* y, int n_pairs, int n_mb,
                                  int d, int F, int E, int per_split,
                                  void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (d % MOE_BK || F % MOE_BK || n_mb < 1 || E < 1 || per_split < 1)
    return (int)cudaErrorInvalidValue;
  const int dev = current_device();
  if (!moe_attrs.done(dev)) {
    cudaError_t e = cudaFuncSetAttribute(
        moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MOE_SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(moe_down_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MOE_SMEM);
    if (e != cudaSuccess) return (int)e;
    moe_attrs.mark(dev);
  }
  const int m = n_mb * MOE_BM;
  CUtensorMap ta, tb;
  if (!moe_maps(&ta, &tb, xs, m, d, w13, E, 2 * F))
    return (int)cudaErrorInvalidValue;
  MoeArgs a{static_cast<const int*>(rows),
            static_cast<const int*>(block_expert),
            static_cast<const float*>(wt),
            h, n_pairs, n_mb, (F + MOE_BN / 2 - 1) / (MOE_BN / 2),
            d / MOE_BK, d / MOE_BK, F};
  moe_gate_up_kernel<<<n_mb * a.n_col, G8Cfg::THREADS, MOE_SMEM, st>>>(ta, tb,
                                                                       a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!moe_maps(&ta, &tb, h, m, F, w2, E, d))
    return (int)cudaErrorInvalidValue;
  a.out = y;
  a.n_col = (d + MOE_BN - 1) / MOE_BN;
  a.n_slabs = F / MOE_BK;
  a.per_split = per_split;
  a.N = d;
  const int splits = (a.n_slabs + per_split - 1) / per_split;
  moe_down_kernel<<<n_mb * a.n_col * splits, G8Cfg::THREADS, MOE_SMEM, st>>>(
      ta, tb, a);
  return (int)cudaGetLastError();
}
