// K6 as it was before its decode kernel moved into csrc/q8_decode.cuh
// (which K7 shares), kept beside the tests as the bits reference for
// csrc/q8_matmul.cu: the same kernels, so the same bits
// (tests/test_torch_kernels_gpu.py builds this file on the card). It
// includes common_v1.cuh, the common.cuh it was built with.
//
// K6: x (M, K) bf16 or f32 @ dequant(int8 (K, N), per-channel scales)
// -> (M, N) f32, each weight tile dequantized to bf16 on chip.
//
// Replaces nobs_whisper_tpu/ops/quant.py::q8_matmul (pallas_call at :73,
// kernel _q8_matmul_kernel :53), which the reference decoder runs from
// models/whisper.py::_dense (:715-721) for M <= 256 and weights of at least
// NWT_Q8_KERNEL_MIN_BYTES bytes. Numerics are the TPU kernel's:
//   w = bf16(bf16(q) * bf16(s))   (the product of two bf16 values, rounded
//                                  once more to bf16);
//   x rounded to bf16; products exact in f32; sums in f32; f32 output.
// The result does not change from run to run: every sum is taken in a
// fixed order and every output element is written once, with a plain
// store, so the wrapper allocates the output uninitialised.
//
// Both kernels swap A and B: out^T = W^T x^T. The dequantized weight tile
// is the 16-row A operand of mma.sync.m16n8k16 (bf16 in, f32 accumulate,
// from ldmatrix.trans) and the rows of x are the n8 side, so no tensor
// work is spent on padding rows. A block owns 128 columns of N, 8 warps.
//
// The weight side (WeightRing), shared by both:
// * Bytes in flight: a ring of raw int8 slabs filled by 16-byte
//   cp.async.cg (L1 not allocated) from the aligned 16-byte words that
//   cover each row's 128 columns. Ragged N (the logit projection's 51,866
//   is 2 mod 16, so a row starts at any byte; any base offset too): a row
//   lands as its 9 aligned words and each thread reads its 16 bytes at
//   the row's offset (5 LDS.32, 4 funnel shifts; one LDS.128 in the
//   decode instantiation for a 16-byte-aligned base and N, which takes
//   fc1 and fc2 at M = 8 in 6-7% less time than the shifting reader:
//   PERF.md, scripts/torch_q8_variants.py). The offset is the
//   same in every slab (slab rows x N is a multiple of 16), so every
//   address and predicate is set up once. TMA needs aligned rows, and
//   1-D bulk copies of a row each (144 bytes, completing on mbarriers)
//   measured slower (PERF.md).
// * Dequantization on the integer and FMA pipes, no I2F or F2F: for the
//   bytes (b0, b2) of a weight word, and (b1, b3) after one shift, one
//   LOP3 builds bf16 128 + (b & 127) exactly (0x4300 | low 7 bits), one
//   LOP3 -(128 + 128 * sign bit) (0xC300 | bit 7 << 7), one HADD2 their
//   sum, the int8 value exactly, and one HMUL2 by the bf16x2 column scales
//   rounds the exact product once: bf16(bf16(q) * bf16(s)). A thread's 16
//   weights of a slab row cost 16 LOP3, 8 HADD2, 8 HMUL2, 4 SHF and two
//   STS.128 (cuobjdump -sass of the built library; the kernels' few I2F
//   and F2FP lie outside the slab loop: the division by x's row length,
//   the rounding of the scales and of f32 x). Pairs (0, 2) and (1, 3) of a
//   word stay in that order in shared memory; the epilogue maps the
//   columns back (a_col).
//
// * Decode, M <= 16 (q8_decode_kernel; every decode step, B <= 8 rows in
//   serving). Bound by bytes: each weight byte meets at most 16 rows, far
//   below the ~295 operations per byte at which the tensor cores would be
//   the limit; the logit projection is 66 MB, 20 us at 3.35 TB/s.
//   - x once per block: the prologue stages the block's (M, K-range)
//     slice of x in shared memory as bf16 (f32 x rounded there), zero past
//     M and past the K range, while the first slabs stream in.
//   - 32-row slabs, 3 in the ring (2 ahead: 9 KB a block, 37 KB an SM),
//     42 KB of shared memory at the logit shape and at most 64 registers
//     (M <= 8): 4 blocks an SM, so all 406 tiles of the logit projection
//     are resident at once (at 3 an SM, 10 ran as a second round and each
//     block's fixed cost was paid twice).
//   - Split-K without a zeroed output: the K range of a tile is split
//     over a thread-block cluster (up to 16 blocks, the non-portable size
//     allowed) until the grid has about one block an SM; each block
//     leaves its partial (M, 128) tile in shared memory, and after a
//     cluster barrier block r sums every partial in rank order through
//     distributed shared memory for its share of the elements. An
//     unsplit grid (the logit projection) is a plain launch, no cluster.
//   - No device query a call: the SM count and the kernels' attributes are
//     set once per process.
//   What holds it above the byte bound (PERF.md): the same read with no
//   dequantization or tensor work takes 0.030 ms at the logit shape, and
//   the kernel's instruction stream, not the memory, is what it adds.
//
// * Prefill, 16 < M <= 256 (q8_prefill_kernel; the prefill's B x P rows).
//   Toward M = 256 the operations catch up with the bytes: at the logit
//   shape 34 GFLOP take 0.034 ms at the bf16 peak and the 120 MB take
//   0.036 ms at 3.35 TB/s, most of them the f32 output's 53 MB of writes,
//   so the bound is still the bytes there. Each slab of the weight (64 rows,
//   2 in the ring) is dequantized once for all of a block's rows (32, 64
//   or 128; M = 256 is two neighbouring blocks of one tile, the second
//   finding the weight in L2); x streams through the ring beside it by
//   cp.async (bf16 x feeds ldmatrix from the ring, f32 x is rounded into
//   a bf16 tile), and warps tile 32 columns by 64 rows, every B fragment
//   feeding two products. An unsplit block stores its sums directly; a
//   split one goes through the same cluster sum. mma.sync, not wgmma:
//   with the products on wgmma (x as A, K-major; the slab as B, MN-major;
//   128-byte swizzles), in these stages or warp-specialized (one or two
//   producer warpgroups copying and dequantizing into a ring of B tiles
//   under mbarriers, two consumer warpgroups), the kernel ran slower at
//   M = 17 and 256: the threads' dequantization and x staging, not the
//   tensor cores, set its pace (PERF.md).

#include <algorithm>

#include "common_v1.cuh"

namespace nwt {

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared, L1 not allocated
__device__ __forceinline__ void cp_async16(const void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// the same, src_bytes (0 or 16) read and the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16_zfill(void* dst, uintptr_t src,
                                                 unsigned src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// all threads of the cluster; shared-memory writes before it are visible
// to every block of the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// four floats at the same shared-memory offset in block `rank` of the
// cluster (distributed shared memory)
__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
  const unsigned a = smem_u32(p);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// The split-K sum: every block of the cluster holds its partial (rows,
// cols) f32 tile at `part` (row stride `ld`, cols % 4 == 0); block `rank`
// of `nsplit` sums its share of the 4-column groups over the ranks in
// order and stores them to out (rows from m0, columns from n0), columns
// >= N dropped. Starts and ends with a cluster barrier.
__device__ __forceinline__ void cluster_reduce_store(
    const float* part, int ld, int rows, int cols, int rank, int nsplit,
    int tid, int nthreads, float* __restrict__ out, int m0, int n0, int N) {
  if (nsplit == 1) {   // one block a tile: its own partial is the sum
    __syncthreads();
    for (int gi = tid; gi < rows * (cols / 4); gi += nthreads) {
      const int r = gi / (cols / 4), c = 4 * (gi % (cols / 4));
      const float4 v = *reinterpret_cast<const float4*>(part + r * ld + c);
      float* o = out + (size_t)(m0 + r) * N + n0 + c;
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + c + i < N) o[i] = a[i];
    }
    return;
  }
  cluster_sync();
  const int groups = rows * (cols / 4);
  for (int gi = rank + nsplit * tid; gi < groups; gi += nsplit * nthreads) {
    const int r = gi / (cols / 4), c = 4 * (gi % (cols / 4));
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < nsplit; ++q) {
      const float4 v = ld_cluster_f4(part + r * ld + c, q);
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    float* o = out + (size_t)(m0 + r) * N + n0 + c;
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + c + i < N) o[i] = a[i];
  }
  cluster_sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// The weight side of both kernels
// ---------------------------------------------------------------------------

constexpr int DBN = 128;               // columns a block
constexpr int DBK = 32;                // weight rows a stage
constexpr int DSTAGES = 3;             // slabs in the ring
constexpr int DTHREADS = 256;          // 8 warps
constexpr int DCPR = DBN / 16;         // 16-byte words a row (a thread each)
constexpr int DRAW = 16 * (DCPR + 1);  // raw bytes a row: one word more
constexpr int DWLD = DBN + 8;          // bf16 a dequantized row
constexpr int DXK_MAX = 2048;          // K rows of x a decode block stages
constexpr int DMAX_CLUSTER = 16;       // blocks splitting one tile's K
constexpr int DSPLIT_TARGET = 1;       // blocks an SM the K split aims at
constexpr int DECODE_ROWS = 16;        // M at which the prefill kernel starts
constexpr int PBK = 64;                // weight rows a prefill stage
constexpr int PSTAGES = 2;             // slabs in a prefill block's ring
static_assert(DCPR == 8, "8 warps of 16 columns");

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// (a & b) | c in one LOP3 (two immediates would take two)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bytes 0 and 2 of v (two int8 weights) -> bf16x2 bf16(bf16(q) * s), s the
// two bf16 column scales; exact up to the one rounding of the product
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, uint32_t s2) {
  const uint32_t m = and_or(v, 0x007F007Fu, 0x43004300u);   // 128 + (q & 127)
  const uint32_t ns = and_or(v, 0x00800080u, 0xC300C300u);  // -128 or -256
  const uint32_t q = fma_bf16x2(m, 0x3F803F80u, ns);        // q, exact
  return fma_bf16x2(q, s2, 0x80008000u);                    // q s, rounded once
}

// shared-memory column e of a 16-byte unit holds byte (e & ~3) | swap of
// e's two low bits of its 8: the pairs (0, 2), (1, 3) of each word
__device__ __forceinline__ int unit_col(int e) {
  return (e & ~3) | ((e & 1) << 1) | ((e >> 1) & 1);
}

// A block's ring of STAGES raw int8 slabs (BK rows of its DBN columns,
// from the K range [kbeg, kend)) and their dequantization into wt, bf16
// [k][n].
// Thread t copies, of every slab, word c = t % DCPR of its RPT rows
// r0 + RSTEP i (the aligned 16-byte words from the one holding the row's
// first column), and threads t < BK the ninth word of row t where the row
// is not 16-byte aligned; no word that starts past the row's end. It then
// dequantizes the 16 columns 16 c.. of the same rows, whose first byte
// lies sh bytes into the row's first word (the same in every slab: BK N
// is a multiple of 16), with its bf16x2 column scales.
template <bool ALIGNED, int BK, int STAGES>
struct WeightRing {
  static constexpr int RSTEP = DTHREADS / DCPR;
  static constexpr int RPT = BK * DCPR / DTHREADS;   // rows a thread
  static_assert(RPT >= 1 && BK <= DTHREADS, "ring tiling");
  const uint8_t* d0;
  const uint8_t* d8;
  bf16* wrow;
  uintptr_t gw[RPT], g8;
  unsigned sh[RPT];
  bool need[RPT], need8;
  uint32_t sc[8];
  size_t slab;
  int c, r0, r8, kspan;

  __device__ __forceinline__ WeightRing(const uint8_t* raw, bf16* wt,
                                        const int8_t* w, const float* s,
                                        int N, int n0, int kbeg, int kend,
                                        int tid) {
    const uintptr_t wb = reinterpret_cast<uintptr_t>(w);
    auto row_at = [&](int r) { return wb + (size_t)(kbeg + r) * N + n0; };
    // bytes of a row this tile reads, counted from its first aligned word
    auto span = [&](uintptr_t row) {
      return (unsigned)(row & 15) + (unsigned)min(DBN, N - n0);
    };
    c = tid % DCPR;
    r0 = tid / DCPR;
    r8 = tid & (BK - 1);
    kspan = kend - kbeg;
    slab = (size_t)BK * N;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const uintptr_t row = row_at(r0 + RSTEP * i);
      gw[i] = (row & ~uintptr_t(15)) + 16 * c;
      sh[i] = (unsigned)(row & 15);
      need[i] = 16u * c < span(row);
    }
    g8 = (row_at(r8) & ~uintptr_t(15)) + 16 * DCPR;
    need8 = !ALIGNED && tid < BK && 16u * DCPR < span(row_at(r8));
    d0 = raw + r0 * DRAW + 16 * c;
    d8 = raw + r8 * DRAW + 16 * DCPR;
    wrow = wt + r0 * DWLD;
    // bf16x2 scales of the byte pairs (4j, 4j + 2) and (4j + 1, 4j + 3)
    // of the thread's 16 columns, 0 past N
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int na = n0 + 16 * c + 4 * j + p, nb = na + 2;
        const bf16 sa = __float2bfloat16_rn(na < N ? s[na] : 0.f);
        const bf16 sb = __float2bfloat16_rn(nb < N ? s[nb] : 0.f);
        sc[2 * j + p] = (uint32_t)__bfloat16_as_ushort(sa) |
                        ((uint32_t)__bfloat16_as_ushort(sb) << 16);
      }
  }

  // issue the copies of slab st into its slot (the caller commits)
  __device__ __forceinline__ void load(int st) const {
    const int so = (st % STAGES) * BK * DRAW;
    const size_t go = (size_t)st * slab;
    const int rows = kspan - st * BK;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (need[i] && r0 + RSTEP * i < rows)
        cp_async16(d0 + so + RSTEP * i * DRAW, gw[i] + go);
    if (need8 && r8 < rows) cp_async16(d8 + so, g8 + go);
  }

  // slab st, landed, into wt: bytes 0-7 of the thread's 16 to unit c of
  // its row, bytes 8-15 to unit c + DCPR (rows past kend are finite
  // leftovers that meet zero x)
  __device__ __forceinline__ void dequant(int st) const {
    const int so = (st % STAGES) * BK * DRAW;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const uint8_t* src = d0 + so + RSTEP * i * DRAW;
      uint32_t v[4];
      if constexpr (ALIGNED) {
        const uint4 q = *reinterpret_cast<const uint4*>(src);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        const uint32_t* p =
            reinterpret_cast<const uint32_t*>(src + (sh[i] & ~3u));
        uint32_t t[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) t[j] = p[j];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = __funnelshift_r(t[j], t[j + 1], 8 * (sh[i] & 3u));
      }
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[2 * j] = dequant_pair(v[j], sc[2 * j]);
        o[2 * j + 1] = dequant_pair(v[j] >> 8, sc[2 * j + 1]);
      }
      bf16* d = wrow + RSTEP * i * DWLD;
      *reinterpret_cast<uint4*>(d + 8 * c) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(d + 8 * (c + DCPR)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

// ldmatrix.trans address of A tile j (the 16 columns of units j and
// j + DCPR, rows 0-7 and 8-15 of the tile) at K row 0 of wt
__device__ __forceinline__ unsigned a_tile_addr(const bf16* wt, int j,
                                                int lane) {
  return smem_u32(wt) + 2 * (((lane & 7) + ((lane >> 4) & 1) * 8) * DWLD +
                             (j + ((lane >> 3) & 1) * DCPR) * 8);
}

// the column of A row rho (0-15) of tile j
__device__ __forceinline__ int a_col(int j, int rho) {
  return 16 * j + (rho & 8) + unit_col(rho & 7);
}

// ---------------------------------------------------------------------------
// Decode: M <= 16
// ---------------------------------------------------------------------------

constexpr size_t decode_smem(int mt, int kper) {
  return (size_t)DSTAGES * DBK * DRAW + (size_t)DBK * DWLD * 2 +
         (size_t)8 * mt * (kper + 8) * 2;
}

template <typename T, int MT, bool ALIGNED>
__global__ void __launch_bounds__(DTHREADS, MT == 1 ? 4 : 2)
q8_decode_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ out, int M,
                 int K, int N, int kper) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* raw = smem;                                   // [S][DBK][DRAW]
  bf16* wt = reinterpret_cast<bf16*>(smem + DSTAGES * DBK * DRAW);
  bf16* xs = wt + DBK * DWLD;                            // [8 MT][kper + 8]
  const int xld = kper + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int n0 = blockIdx.y * DBN;
  const int kbeg = rank * kper, kend = min(K, kbeg + kper);
  const int nst = (kend - kbeg + DBK - 1) / DBK;
  const WeightRing<ALIGNED, DBK, DSTAGES> ring(raw, wt, w, s, N, n0, kbeg,
                                               kend, tid);

#pragma unroll
  for (int st = 0; st < DSTAGES - 1; ++st) {
    if (st < nst) ring.load(st);
    cp_async_commit();
  }

  // the block's x: (8 MT, kper) bf16, zero past M and past kend, XV
  // values a thread and step (16 bytes of bf16 x, 16 of f32 x)
  {
    constexpr int XV = sizeof(T) == 2 ? 8 : 4;
    const bool vec = (K % XV == 0) &&
                     (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int per_row = kper / XV;
    for (int e = tid; e < 8 * MT * per_row; e += DTHREADS) {
      const int m = e / per_row, kx = XV * (e % per_row);
      const int k = kbeg + kx;
      uint32_t v[XV / 2] = {};
      if (m < M && k < kend) {
        const T* src = x + (size_t)m * K + k;
        if (vec) {
          if constexpr (XV == 8) {
            const uint4 q = *reinterpret_cast<const uint4*>(src);
            v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
          } else {
            const float4 a = *reinterpret_cast<const float4*>(src);
            const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
            const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
            v[0] = *reinterpret_cast<const uint32_t*>(&h0);
            v[1] = *reinterpret_cast<const uint32_t*>(&h1);
          }
        } else {
#pragma unroll
          for (int i = 0; i < XV; ++i) {
            const bf16 h = k + i < kend ? to_bf16(src[i])
                                        : __float2bfloat16_rn(0.f);
            v[i / 2] |= (uint32_t)__bfloat16_as_ushort(h) << (16 * (i & 1));
          }
        }
      }
      if constexpr (XV == 8)
        *reinterpret_cast<uint4*>(xs + m * xld + kx) =
            make_uint4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<uint2*>(xs + m * xld + kx) = make_uint2(v[0], v[1]);
    }
  }

  // warp w: A tile w; B: 8 MT rows of x, 16 of its K columns
  const unsigned a_addr = a_tile_addr(wt, warp, lane);
  const unsigned b_addr = smem_u32(xs) +
      2 * (((lane & 7) + (MT == 2 ? ((lane >> 4) & 1) * 8 : 0)) * xld +
           ((lane >> 3) & 1) * 8);
  float acc[MT][4] = {};

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<DSTAGES - 2>();
    __syncthreads();   // slab `it` landed; every thread is done with the
                       // slot it refills and with the last slab's mma
    if (it + DSTAGES - 1 < nst) ring.load(it + DSTAGES - 1);
    cp_async_commit();
    ring.dequant(it);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < DBK; kk += 16) {
      uint32_t a[4], b[4];
      ldsm_x4_trans(a, a_addr + 2 * kk * DWLD);
      const unsigned bk = b_addr + 2 * (it * DBK + kk);
      if constexpr (MT == 1)
        ldsm_x2(reinterpret_cast<uint32_t(&)[2]>(b), bk);
      else
        ldsm_x4(b, bk);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma_bf16(acc[mt], a, b[2 * mt], b[2 * mt + 1]);
    }
  }

  // this block's partial (8 MT, DBN) tile, columns in order, over the ring
  cp_async_wait<0>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(mt * 8 + 2 * t + (e & 1)) * DBN +
           a_col(warp, g + (e >= 2 ? 8 : 0))] = acc[mt][e];
  cluster_reduce_store(part, DBN, M, DBN, rank, nsplit, tid, DTHREADS, out,
                       0, n0, N);
}

// ---------------------------------------------------------------------------
// Prefill: 16 < M <= 256
// ---------------------------------------------------------------------------

constexpr int XLD = PBK + 8;   // bf16 a staged row of x: 144 B, ldmatrix
                               // conflict-free

// rows of x a block stages: 8 MT, in a ring beside the weight's (bf16 x
// rows of XLD, f32 x rows of PBK floats converted into xb); the partial
// tile of a split block lies over the whole of it
template <typename T>
constexpr size_t prefill_ring(int mt) {
  return (size_t)PSTAGES * PBK * DRAW + (size_t)PBK * DWLD * 2 +
         (size_t)PSTAGES * 8 * mt *
             (sizeof(T) == 2 ? XLD * 2 : PBK * sizeof(T)) +
         (size_t)8 * mt * XLD * 2;
}

template <typename T>
constexpr size_t prefill_smem(int mt, bool split) {
  return split ? std::max(prefill_ring<T>(mt), (size_t)8 * mt * DBN * 4)
               : prefill_ring<T>(mt);
}

// A block takes rows m0 .. m0 + 8 MT of x (blockIdx.y = tile x chunks +
// chunk, so that the blocks of one tile are neighbours in the grid and
// find its weight in L2 after the first). Warps tile the block's DBN
// columns and 8 MT rows: GN groups of WN A tiles (16 columns each) by GM
// groups of WMT m8 tiles; each B fragment (16 K x 8 rows of x) feeds WN
// tensor-core products.
template <typename T, int MT>
__global__ void __launch_bounds__(DTHREADS, 2)
q8_prefill_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ s, float* __restrict__ out, int M,
                  int K, int N, int kper) {
  const int chunks = (M + 8 * MT - 1) / (8 * MT);
  const int tile = blockIdx.y / chunks;
  {
    const int m0 = 8 * MT * (blockIdx.y % chunks);
    x += (size_t)m0 * K;
    out += (size_t)m0 * N;
    M = min(8 * MT, M - m0);
  }
  constexpr int WN = MT >= 8 ? 2 : 1, GN = DCPR / WN, GM = 8 / GN;
  constexpr int WMT = MT / GM;
  constexpr int XROW = sizeof(T) == 2 ? XLD * 2 : PBK * 4;   // ring bytes
  static_assert(GN * GM == DTHREADS / 32 && WMT % 2 == 0, "warp tiling");
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* raw = smem;
  bf16* wt = reinterpret_cast<bf16*>(smem + PSTAGES * PBK * DRAW);
  uint8_t* xr = reinterpret_cast<uint8_t*>(wt + PBK * DWLD);
  bf16* xb = reinterpret_cast<bf16*>(xr + PSTAGES * 8 * MT * XROW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nsplit = gridDim.x;
  const int n0 = tile * DBN;
  const int kbeg = rank * kper, kend = min(K, kbeg + kper);
  const int nst = (kend - kbeg + PBK - 1) / PBK;
  const WeightRing<false, PBK, PSTAGES> ring(raw, wt, w, s, N, n0, kbeg,
                                            kend, tid);
  // x by cp.async in 16-byte pieces (zero-filled past M and kend), or, for
  // a K or a base that is not 16-byte aligned, by plain loads into xb
  constexpr int XV = 16 / sizeof(T);
  const bool vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool direct = sizeof(T) == 2 && vec;   // ldmatrix from the ring

  auto load_stage = [&](int st) {
    if (st < nst) {
      ring.load(st);
      if (vec) {
        const int k0 = kbeg + st * PBK;
        uint8_t* dst = xr + (st % PSTAGES) * 8 * MT * XROW;
        for (int u = tid; u < 8 * MT * (PBK / XV); u += DTHREADS) {
          const int m = u / (PBK / XV), q = u % (PBK / XV);
          const int k = k0 + XV * q;
          const bool ok = m < M && k < kend;
          cp_async16_zfill(dst + m * XROW + 16 * q,
                           ok ? reinterpret_cast<uintptr_t>(
                                    x + (size_t)m * K + k)
                              : reinterpret_cast<uintptr_t>(x),
                           ok ? 16u : 0u);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int st = 0; st < PSTAGES - 1; ++st) load_stage(st);

  const int gn = warp % GN, gm = warp / GN;
  unsigned a_addr[WN];
#pragma unroll
  for (int j = 0; j < WN; ++j) a_addr[j] = a_tile_addr(wt, gn * WN + j, lane);
  // B: x rows 8 WMT gm + 16 p + (lane & 7) + 8 (lane bit 4), K column kk +
  // 8 (lane bit 3) of the slab
  const unsigned b_lane =
      2 * ((8 * WMT * gm + (lane & 7) + ((lane >> 4) & 1) * 8) * XLD +
           ((lane >> 3) & 1) * 8);
  float acc[WN][WMT][4] = {};

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<PSTAGES - 2>();
    __syncthreads();
    load_stage(it + PSTAGES - 1);
    ring.dequant(it);
    if (!direct) {   // this slab of x into xb as bf16
      const int k0 = kbeg + it * PBK;
      const uint8_t* src = xr + (it % PSTAGES) * 8 * MT * XROW;
      for (int u = tid; u < 8 * MT * (PBK / 8); u += DTHREADS) {
        const int m = u / (PBK / 8), q = u % (PBK / 8);
        uint32_t v[4] = {};
        if (vec) {   // f32: 8 staged floats
          const float4 a = *reinterpret_cast<const float4*>(
              src + m * XROW + 32 * q);
          const float4 b = *reinterpret_cast<const float4*>(
              src + m * XROW + 32 * q + 16);
          const float f[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const __nv_bfloat162 h =
                __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
            v[i] = *reinterpret_cast<const uint32_t*>(&h);
          }
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = k0 + 8 * q + i;
            const bf16 h = m < M && k < kend
                               ? to_bf16(x[(size_t)m * K + k])
                               : __float2bfloat16_rn(0.f);
            v[i / 2] |= (uint32_t)__bfloat16_as_ushort(h) << (16 * (i & 1));
          }
        }
        *reinterpret_cast<uint4*>(xb + m * XLD + 8 * q) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    const unsigned b_base =
        (direct ? smem_u32(xr + (it % PSTAGES) * 8 * MT * XROW)
                : smem_u32(xb)) + b_lane;
#pragma unroll
    for (int kk = 0; kk < PBK; kk += 16) {
      uint32_t a[WN][4];
#pragma unroll
      for (int j = 0; j < WN; ++j)
        ldsm_x4_trans(a[j], a_addr[j] + 2 * kk * DWLD);
#pragma unroll
      for (int p = 0; p < WMT / 2; ++p) {
        uint32_t b[4];
        ldsm_x4(b, b_base + 2 * (16 * p * XLD + kk));
#pragma unroll
        for (int j = 0; j < WN; ++j) {
          mma_bf16(acc[j][2 * p], a[j], b[0], b[1]);
          mma_bf16(acc[j][2 * p + 1], a[j], b[2], b[3]);
        }
      }
    }
  }

  cp_async_wait<0>();
  const int g = lane >> 2, t = lane & 3;
  if (nsplit == 1) {   // the block's sums are the output
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int p = 0; p < WMT; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * (WMT * gm + p) + 2 * t + (e & 1);
          const int n = n0 + a_col(gn * WN + j, g + (e >= 2 ? 8 : 0));
          if (m < M && n < N) out[(size_t)m * N + n] = acc[j][p][e];
        }
    return;
  }
  __syncthreads();   // the partial lies over the rings
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int p = 0; p < WMT; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * (WMT * gm + p) + 2 * t + (e & 1)) * DBN +
             a_col(gn * WN + j, g + (e >= 2 ? 8 : 0))] = acc[j][p][e];
  cluster_reduce_store(part, DBN, M, DBN, rank, nsplit, tid, DTHREADS, out,
                       0, n0, N);
}

}  // namespace nwt

namespace {

using namespace nwt;

// set once per process, and per library (internal linkage: a script may
// load two builds of this file side by side)
int g_sms = 0;

int sm_count() {
  if (g_sms == 0) {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    g_sms = n > 0 ? n : 132;
  }
  return g_sms;
}

// one DBN-column tile a cluster, its K range split in `split` parts of
// `per` slabs until the grid holds about DSPLIT_TARGET blocks an SM (at
// most DMAX_CLUSTER blocks a cluster, at most `max_slabs` slabs a block)
void split_k(int K, int N, int bk, int max_slabs, int& split, int& per) {
  const int tiles = (N + DBN - 1) / DBN, slabs = (K + bk - 1) / bk;
  int want = (DSPLIT_TARGET * sm_count() + tiles - 1) / tiles;
  want = std::max(1, std::min(want, std::min(DMAX_CLUSTER, slabs)));
  per = std::min((slabs + want - 1) / want, max_slabs);
  split = (slabs + per - 1) / per;
}

// a plain launch for an unsplit grid (it costs the host less), else a
// cluster of `split` blocks along x
template <typename Kern, typename T>
cudaError_t launch(Kern kernel, int split, int tiles, size_t smem,
                   cudaStream_t st, const T* x, const int8_t* w,
                   const float* s, float* out, int M, int K, int N,
                   int kper) {
  if (split > DMAX_CLUSTER || tiles > 65535) return cudaErrorInvalidValue;
  if (split == 1) {
    kernel<<<dim3(1, tiles), DTHREADS, smem, st>>>(x, w, s, out, M, K, N,
                                                   kper);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w, s, out, M, K, N, kper);
}

// the kernel's attributes, once per process: its largest shared memory
// and clusters past the portable 8 blocks
template <typename Kern>
cudaError_t prepare(Kern kernel, bool& ready, size_t smem) {
  if (ready) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  ready = e == cudaSuccess;
  return e;
}

template <typename T, int MT, bool ALIGNED>
cudaError_t launch_decode(const T* x, const int8_t* w, const float* s,
                          float* out, int M, int K, int N, cudaStream_t st) {
  static bool ready = false;
  auto kernel = q8_decode_kernel<T, MT, ALIGNED>;
  cudaError_t e = prepare(kernel, ready, decode_smem(MT, DXK_MAX));
  if (e != cudaSuccess) return e;
  int split, per;
  split_k(K, N, DBK, DXK_MAX / DBK, split, per);
  return launch(kernel, split, (N + DBN - 1) / DBN,
                decode_smem(MT, per * DBK), st, x, w, s, out, M, K, N,
                per * DBK);
}

template <typename T, int MT>
cudaError_t launch_prefill(const T* x, const int8_t* w, const float* s,
                           float* out, int M, int K, int N, cudaStream_t st) {
  static bool ready = false;
  auto kernel = q8_prefill_kernel<T, MT>;
  cudaError_t e = prepare(kernel, ready, prefill_smem<T>(MT, true));
  if (e != cudaSuccess) return e;
  int split, per;
  split_k(K, N, PBK, 1 << 20, split, per);
  const int chunks = (M + 8 * MT - 1) / (8 * MT);
  return launch(kernel, split, (N + DBN - 1) / DBN * chunks,
                prefill_smem<T>(MT, split > 1), st, x, w, s, out, M, K, N,
                per * PBK);
}

template <typename T>
cudaError_t launch_q8_matmul(const T* x, const int8_t* w, const float* s,
                             float* out, int M, int K, int N,
                             cudaStream_t st) {
  if (M <= 0 || K <= 0 || N <= 0 || M > 256) return cudaErrorInvalidValue;
  if (M > DECODE_ROWS) {   // blocks of 32, 64 or 128 rows of x
    if (M <= 32) return launch_prefill<T, 4>(x, w, s, out, M, K, N, st);
    if (M <= 64) return launch_prefill<T, 8>(x, w, s, out, M, K, N, st);
    return launch_prefill<T, 16>(x, w, s, out, M, K, N, st);
  }
  const bool aligned =
      reinterpret_cast<uintptr_t>(w) % 16 == 0 && N % 16 == 0;
  if (M <= 8)
    return aligned ? launch_decode<T, 1, true>(x, w, s, out, M, K, N, st)
                   : launch_decode<T, 1, false>(x, w, s, out, M, K, N, st);
  return aligned ? launch_decode<T, 2, true>(x, w, s, out, M, K, N, st)
                 : launch_decode<T, 2, false>(x, w, s, out, M, K, N, st);
}

}  // namespace

// x (M, K) bf16 or f32 row-major; w (K, N) int8 row-major (the reference's
// (d_in, d_out) layout, any byte alignment); s (N,) f32; out (M, N) f32,
// every element written once (the caller need not initialise it).
// M <= 256.
extern "C" int nwt_q8_matmul_bf16(const void* x, const void* w, const void* s,
                                  void* out, int M, int K, int N,
                                  void* stream) {
  return (int)launch_q8_matmul(
      static_cast<const nwt::bf16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), M, K, N,
      reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int nwt_q8_matmul_f32(const void* x, const void* w, const void* s,
                                 void* out, int M, int K, int N,
                                 void* stream) {
  return (int)launch_q8_matmul(
      static_cast<const float*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(s), static_cast<float*>(out), M, K, N,
      reinterpret_cast<cudaStream_t>(stream));
}
