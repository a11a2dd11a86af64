// The int8 GEMM main loop on Hopper (sm_90a): a block's 128 x BN tile of
// A (M, K) B^T with A (M, K) and B (N, K) int8 row-major, summed exactly in
// int32. Used by fused_mlp.cu (K2, K8 and K12's MLP half) and
// proj_wgmma.cuh's kernels (K10, K11, and K1's and K12's q/k/v and o
// projections).
//
// Both operands K-major: 8-bit wgmma reads B from shared memory K-major
// only, so a weight stored (K, N) row-major (the reference layout) is
// given here as its transposed copy (N, K), made once per weight by the
// caller (ops/quant.py::k_major).
//
// The pieces, each used by a kernel that owns the rest (its epilogue):
//   * G8Cfg: every kernel on this loop runs blocks of 384 threads, its two
//     consumer warpgroups and the producer's, setmaxnreg moving the
//     producer's registers to the consumers; BUDGET is the dynamic shared
//     memory a block has for its ring and an epilogue tile.
//   * G8Tile<BN>: a ring stage holds one K slab of G8_BK = 128 bytes, the
//     A tile's 128 rows (64 a consumer warpgroup) and the B tile's BN rows,
//     each row one 128-byte swizzle atom wide, as the TMA leaves them under
//     the 128-byte swizzle; stages are 1024-byte aligned. The block's
//     threads: its two consumer warpgroups, then the producer's, whose
//     first thread issues the loads.
//   * g8_produce: one thread keeps the ring full: for each slab it waits
//     for the stage's "empty" mbarrier, arms the "full" one with the
//     stage's bytes and issues the two TMA loads. Rows past the end of A
//     (M) or B read as zero through the TMA's out-of-bounds fill.
//   * wgmma_s8, g8_mma, g8_mma_slab: a consumer warpgroup (64 rows of the
//     tile) issues wgmma.m64nBNk32.s32.s8.s8 (32 bytes of K each: the
//     descriptors step 32 bytes inside the swizzle atom), a slab's four as
//     one commit group. `zero` makes the slab's first step overwrite the
//     accumulator (scale-d = 0) instead of adding to it, so a caller that
//     restarts its sum (fc2's chunks) never writes the accumulator itself:
//     ptxas serializes every wgmma (C7515) when an instruction other than a
//     wgmma defines an accumulator in flight.
//   * g8_mma_half: the same for one 64-column half of the B tile
//     (wgmma.m64n64k32), for a caller that flushes one half's sum while
//     the other half's products run.
//   The caller retires the groups (wgmma_wait<1> keeps one in flight) and
//   frees slab it - 1's stage after slab it's group is issued: one arrival
//   per consumer warpgroup on the stage's "empty" mbarrier.
//   * cluster helpers (barrier, ranks, distributed shared memory) for
//     kernels whose blocks cooperate.
//
// Accumulator layout (as every wgmma m64nN): element 4 j + 2 h + e of a
// consumer thread is row 16 warp + lane / 4 + 8 h of its warpgroup's 64,
// column 8 j + 2 (lane % 4) + e.

#pragma once

#include "hopper.cuh"

namespace nwt {

constexpr int G8_BK = 128;        // bytes of K a slab: one swizzle atom

struct G8Cfg {
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536, "regs");
  // the block's 227 KB less the alignment slack and the static mbarriers
  static constexpr int BUDGET = 232448 - 2048;
};

template <int BN>
struct G8Tile {
  static_assert(BN % 32 == 0 && BN <= 256, "wgmma N and the TMA box");
  static constexpr int PRODUCER = 256;            // the loads' thread
  static constexpr int A_BYTES = 128 * G8_BK;
  static constexpr int B_BYTES = BN * G8_BK;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int NACC = BN / 2;             // s32 a consumer thread
  static_assert(B_BYTES % 1024 == 0, "1024-byte aligned stages");
};

#define G8_S32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define G8_S64                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "        \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "        \
  "%60, %61, %62, %63"
#define G8_S80                                                          \
  G8_S64 ", %64, %65, %66, %67, %68, %69, %70, %71, "                   \
  "%72, %73, %74, %75, %76, %77, %78, %79"
#define G8_S128                                                         \
  G8_S80 ", %80, %81, %82, %83, "                                       \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "  \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define G8_R8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define G8_R32 G8_R8(0), G8_R8(8), G8_R8(16), G8_R8(24)
#define G8_R64                                                          \
  G8_R8(0), G8_R8(8), G8_R8(16), G8_R8(24), G8_R8(32), G8_R8(40),       \
      G8_R8(48), G8_R8(56)
#define G8_R80 G8_R64, G8_R8(64), G8_R8(72)
#define G8_R128                                                         \
  G8_R80, G8_R8(80), G8_R8(88), G8_R8(96), G8_R8(104), G8_R8(112),      \
      G8_R8(120)
// the predicate p (scale-d) from operand n; the descriptors before it
#define G8_WGMMA(N, REGS, A, B, P)                                      \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                      \
  "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8 {" REGS        \
  "}, %" #A ", %" #B ", p;\n}\n"

// D (64 x BN s32) = A (64 x 32) B (32 x BN) + (acc ? D : 0), both s8,
// K-major in shared memory under the 128-byte swizzle
template <int BN>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[BN / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (BN == 256)
    asm volatile(G8_WGMMA(256, G8_S128, 128, 129, 130)
                 : G8_R128 : "l"(da), "l"(db), "r"(acc));
  else if constexpr (BN == 160)
    asm volatile(G8_WGMMA(160, G8_S80, 80, 81, 82)
                 : G8_R80 : "l"(da), "l"(db), "r"(acc));
  else if constexpr (BN == 128)
    asm volatile(G8_WGMMA(128, G8_S64, 64, 65, 66)
                 : G8_R64 : "l"(da), "l"(db), "r"(acc));
  else
    asm volatile(G8_WGMMA(64, G8_S32, 32, 33, 34)
                 : G8_R32 : "l"(da), "l"(db), "r"(acc));
  static_assert(BN == 256 || BN == 160 || BN == 128 || BN == 64,
                "tile widths built");
}

// The producer's loop: n_slabs slabs of K, A's rows from m0 (ta: an int8
// (M, K) map, boxes of 128 bytes x 128 rows) and B's from n0 (tb: an int8
// (N, K) map, boxes of 128 bytes x BN rows), into a ring of STAGES stages
// whose slab g0 is next (a block that walks several tiles keeps counting).
template <int BN, int STAGES>
__device__ __forceinline__ void g8_produce(const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint32_t ring, uint32_t full,
                                           uint32_t empty, int n_slabs,
                                           int m0, int n0, int g0 = 0) {
  using L = G8Tile<BN>;
  for (int it = 0; it < n_slabs; ++it) {
    const int g = g0 + it, s = g % STAGES;
    if (g >= STAGES) mbar_wait(empty + 8 * s, ((g / STAGES) & 1) ^ 1);
    mbar_expect_tx(full + 8 * s, L::STAGE);
    const uint32_t dst = ring + s * L::STAGE;
    tma_load(dst, ta, it * G8_BK, m0, full + 8 * s);
    tma_load(dst + L::A_BYTES, tb, it * G8_BK, n0, full + 8 * s);
  }
}

// The products of one K slab (64 A rows at `a`, BN B rows at `b`, both
// 128 bytes a row, swizzled) as one commit group.
template <int BN>
__device__ __forceinline__ void g8_mma(uint32_t (&acc)[BN / 2], uint32_t a,
                                       uint32_t b, bool zero) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G8_BK / 32; ++kk)
    wgmma_s8<BN>(acc, smem_desc(a + 32 * kk, 1024, 1),
                 smem_desc(b + 32 * kk, 1024, 1), !(zero && kk == 0));
  wgmma_commit();
}

// The products of one K slab on B rows [64 half, 64 half + 64) of a B
// tile, into a 64-column sum that they restart (scale-d = 0 at the first
// step), as one commit group.
__device__ __forceinline__ void g8_mma_half(uint32_t (&acc)[32], uint32_t a,
                                            uint32_t b, int half) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < G8_BK / 32; ++kk)
    wgmma_s8<64>(acc, smem_desc(a + 32 * kk, 1024, 1),
                 smem_desc(b + half * 64 * G8_BK + 32 * kk, 1024, 1),
                 kk != 0);
  wgmma_commit();
}

// Consumer warpgroup wg (0 or 1) waits for slab it's stage (it counted as
// g8_produce counts g) and issues its products.
template <int BN, int STAGES>
__device__ __forceinline__ void g8_mma_slab(uint32_t (&acc)[BN / 2],
                                            uint32_t ring, uint32_t full,
                                            int it, int wg, bool zero) {
  using L = G8Tile<BN>;
  const int s = it % STAGES;
  mbar_wait(full + 8 * s, (it / STAGES) & 1);
  g8_mma<BN>(acc, ring + s * L::STAGE + wg * 64 * G8_BK,
             ring + s * L::STAGE + L::A_BYTES, zero);
}

// The ring's mbarriers: "full" (one arrival, the producer's expect_tx,
// completed by the TMA's bytes) and "empty" (one arrival a consumer
// warpgroup); thread 0, before the block's first barrier.
template <int STAGES>
__device__ __forceinline__ void g8_init_bars(uint32_t full, uint32_t empty) {
  for (int s = 0; s < STAGES; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, 2);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a bar.sync over `threads` threads with an immediate id (0 is
// __syncthreads)
template <int ID>
__device__ __forceinline__ void g8_bar(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(threads) : "memory");
}

// an int8 2-D tensor map: rows of `cols` bytes (pitch `pitch`), boxes of
// 128 bytes x box_rows rows under the 128-byte swizzle, zero fill
inline bool g8_map(CUtensorMap* map, const void* z, int cols, int rows,
                   int pitch, int box_rows) {
  EncodeTiledFn enc = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)G8_BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(z),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace nwt
