// The int8 dequantizing GEMV of a decode step on Hopper: K6's decode kernel
// (csrc/q8_matmul.cu, M <= 32), which K7's two products (csrc/fused_mlp_q8.cu)
// run too, and the weight side that K6's prefill kernel shares.
//
// out^T = W^T x^T, W = bf16(bf16(q) * bf16(s)) per column, x's rows
// rounded to bf16, products exact in f32, f32 sums (the TPU kernels'
// rounding points). The dequantized weight tile is the 16-row A operand of
// mma.sync.m16n8k16 (from ldmatrix.trans) and the rows of x are the n8
// side, so no tensor work is spent on padding rows. A block owns DBN = 128
// columns of N, 8 warps.
//
// The weight side (WeightRing):
// * Bytes in flight: a ring of raw int8 slabs filled by 16-byte
//   cp.async.cg (L1 not allocated) from the aligned 16-byte words that
//   cover each row's 128 columns. Ragged N (the logit projection's 51,866
//   is 2 mod 16, so a row starts at any byte; any base offset too): a row
//   lands as its 9 aligned words and each thread reads its 16 bytes at
//   the row's offset (5 LDS.32, 4 funnel shifts; one LDS.128 in the
//   ALIGNED instantiation for a 16-byte-aligned base and N, which takes
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
//   STS.128 (cuobjdump -sass of the built library). Pairs (0, 2) and
//   (1, 3) of a word stay in that order in shared memory; the epilogue
//   maps the columns back (a_col).
//
// The decode kernel (q8_decode_kernel). Bound by bytes: each weight byte
// meets at most 32 rows, far below the ~295 operations per byte at which
// the tensor cores would be the limit.
//   - x's rows in MT tiles of 8 (MT 1, 2 or 4: M <= 8, 16, 32, the rows of
//     a serving step): each dequantized A fragment feeds MT products, so a
//     weight slab is read and dequantized once for all the block's rows.
//     The split depends on (K, N) and the card, never on M, and a row's
//     products and sums run in the same order at every MT: a row's output
//     bits do not depend on the rows beside it.
//   - x once per block: a row prologue stages the block's (M, K-range)
//     slice of its rows in shared memory as bf16, zero past M and past the
//     K range, while the first slabs stream in: x's rows as they are (f32
//     x rounded there; K6, K7's fc2), or bf16(LN(x)) (K7's fc1), each row's
//     mean and variance taken over the whole row by every block in f32, in
//     the order of K7's first kernel.
//   - 32-row slabs, 3 in the ring (2 ahead: 9 KB a block, 37 KB an SM),
//     42 KB of shared memory at the logit shape and at most 64 registers
//     (M <= 8): 4 blocks an SM, so all 406 tiles of the logit projection
//     are resident at once.
//   - Split-K without a zeroed output: the K range of a tile is split
//     over a thread-block cluster (up to 16 blocks, the non-portable size
//     allowed) until the grid has about one block an SM (split_k); each
//     block leaves its partial (M, 128) tile in shared memory, and after a
//     cluster barrier block r sums every partial in rank order through
//     distributed shared memory for its share of the elements and hands
//     each sum to the epilogue once: an f32 store (K6), a bf16 store with
//     the bias added in bf16 (K6 at bf16 compute), + b1 then the tanh gelu
//     and a bf16 store (K7's fc1), or + b2 + x in x's type (K7's fc2). An
//     unsplit grid is a plain launch, no cluster.
//   - Programmatic dependent launch, for a kernel that follows another on
//     the stream (K7's fc2 after fc1): the PDL_WAIT instantiation issues
//     its first slabs before griddepcontrol.wait and stages x after it;
//     PDL_TRIGGER lets the next grid start once its main loop is done. On
//     a launch without the attribute both are no-ops.
//   - No device query a call: the SM count and the kernels' attributes are
//     set once per process.
//   What holds it above the byte bound (PERF.md): the same read with no
//   dequantization or tensor work takes 0.030 ms at the logit shape, and
//   the kernel's instruction stream, not the memory, is what it adds.

#pragma once

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace nwt {

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
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

// four floats at the same shared-memory offset in block `rank` of the
// cluster (distributed shared memory)
__device__ __forceinline__ float4 ld_cluster_f4(const float* p, int rank) {
  const uint32_t r = cluster_addr(smem_u32(p), rank);
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// Epilogues: what becomes of an output sum v at (row m, column n < N)
// ---------------------------------------------------------------------------

// K6: out (M, N) f32
struct StoreF32 {
  float* out;
  __device__ __forceinline__ void operator()(int m, int n, int N,
                                             float v) const {
    out[(size_t)m * N + n] = v;
  }
};

// K6 at bf16 compute: bf16(v), then + b in bf16 where a bias is given
// (PyTorch's bf16 add: the f32 sum of the two bf16 values, rounded once),
// (M, N) bf16: the bits of out.to(bf16) + b after StoreF32
struct StoreBf16Bias {
  const bf16* bias;   // (N,), or null
  bf16* out;
  __device__ __forceinline__ void operator()(int m, int n, int N,
                                             float v) const {
    bf16 y = __float2bfloat16_rn(v);
    if (bias != nullptr)
      y = __float2bfloat16_rn(
          __fadd_rn(__bfloat162float(y), __bfloat162float(bias[n])));
    out[(size_t)m * N + n] = y;
  }
};

// K7's fc1: a = bf16(gelu_tanh(v + b1)), (M, N) bf16
struct BiasGeluBf16 {
  const float* bias;
  bf16* out;
  __device__ __forceinline__ void operator()(int m, int n, int N,
                                             float v) const {
    out[(size_t)m * N + n] =
        __float2bfloat16_rn(gelu_tanh(__fadd_rn(v, bias[n])));
  }
};

// K7's fc2: out = T(f32(x) + (v + b2)), x and out (M, N) in T
template <typename T>
struct BiasResidual {
  const float* bias;
  const T* x;
  T* out;
  __device__ __forceinline__ void operator()(int m, int n, int N,
                                             float v) const {
    const size_t i = (size_t)m * N + n;
    out[i] = from_f32<T>(__fadd_rn(to_f32(x[i]), __fadd_rn(v, bias[n])));
  }
};

// The split-K sum: every block of the cluster holds its partial (rows,
// cols) f32 tile at `part` (row stride `ld`, cols % 4 == 0); block `rank`
// of `nsplit` sums its share of the 4-column groups over the ranks in
// order and hands them to the epilogue (columns from n0), columns >= N
// dropped. Starts and ends with a cluster barrier.
template <class Epi>
__device__ __forceinline__ void cluster_reduce_store(
    const float* part, int ld, int rows, int cols, int rank, int nsplit,
    int tid, int nthreads, int n0, int N, const Epi& epi) {
  if (nsplit == 1) {   // one block a tile: its own partial is the sum
    __syncthreads();
    for (int gi = tid; gi < rows * (cols / 4); gi += nthreads) {
      const int r = gi / (cols / 4), c = 4 * (gi % (cols / 4));
      const float4 v = *reinterpret_cast<const float4*>(part + r * ld + c);
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + c + i < N) epi(r, n0 + c + i, N, a[i]);
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
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (n0 + c + i < N) epi(r, n0 + c + i, N, a[i]);
  }
  cluster_sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// The weight side of both of K6's kernels
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
// Row prologues: the block's (8 MT, kper) slice of its rows as bf16 in xs
// (row stride kper + 8), zero past M and past kend
// ---------------------------------------------------------------------------

// x's rows as they are (f32 x rounded to bf16), XV values a thread and
// step (16 bytes of bf16 x, 16 of f32 x)
struct RowsAsIs {};

template <int MT, typename T>
__device__ __forceinline__ void stage_rows(const RowsAsIs&, bf16* xs,
                                           const T* x, int M, int K,
                                           int kbeg, int kend, int kper,
                                           int tid) {
  constexpr int XV = sizeof(T) == 2 ? 8 : 4;
  const int xld = kper + 8;
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

// 8 consecutive values of x as f32, from 16-byte-aligned memory
__device__ __forceinline__ void load8f(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// bf16(LN(x)): LayerNorm in f32 (biased variance, 1 / sqrt(var + 1e-5),
// * g + b), one warp a row, each row's mean and variance over the whole
// row in the arithmetic of K7's first kernel: lane-strided f32 sums,
// warp_sum, correctly rounded divisions and square root; x
// 16-byte aligned and K % 8 == 0
struct RowsLayerNorm {
  const float* g;
  const float* b;
};

template <int MT, typename T>
__device__ __forceinline__ void stage_rows(const RowsLayerNorm& ln,
                                           bf16* xs, const T* x, int M,
                                           int K, int kbeg, int kend,
                                           int kper, int tid) {
  __shared__ float mean[8 * MT], rstd[8 * MT];
  const int lane = tid & 31, warp = tid >> 5, xld = kper + 8;
  for (int m = warp; m < M; m += DTHREADS / 32) {
    const T* xr = x + (size_t)m * K;
    float sum = 0.f;
    for (int c = lane; c < K; c += 32) sum += to_f32(xr[c]);
    const float mu = __fdiv_rn(warp_sum(sum), (float)K);
    float s2 = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float dv = __fsub_rn(to_f32(xr[c]), mu);
      s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
    }
    const float var = __fdiv_rn(warp_sum(s2), (float)K);
    if (lane == 0) {
      mean[m] = mu;
      rstd[m] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    }
  }
  __syncthreads();
  for (int e = tid; e < 8 * MT * (kper / 8); e += DTHREADS) {
    const int m = e / (kper / 8), kx = 8 * (e % (kper / 8)), k = kbeg + kx;
    uint32_t v[4] = {};
    if (m < M && k < kend) {   // kend - kbeg is a multiple of 8
      float f[8], g[8], b[8];
      load8f(x + (size_t)m * K + k, f);
      load8f(ln.g + k, g);
      load8f(ln.b + k, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float h[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = 2 * i + j;
          const float u = __fmul_rn(__fsub_rn(f[t], mean[m]), rstd[m]);
          h[j] = __fadd_rn(__fmul_rn(u, g[t]), b[t]);
        }
        const __nv_bfloat162 p = __floats2bfloat162_rn(h[0], h[1]);
        v[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
    }
    *reinterpret_cast<uint4*>(xs + m * xld + kx) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// Decode: M <= 32
// ---------------------------------------------------------------------------

constexpr size_t decode_smem(int mt, int kper) {
  return (size_t)DSTAGES * DBK * DRAW + (size_t)DBK * DWLD * 2 +
         (size_t)8 * mt * (kper + 8) * 2;
}

// what a launch does about programmatic dependent launch
constexpr int PDL_NONE = 0;
constexpr int PDL_TRIGGER = 1;   // the next grid may start after the main loop
constexpr int PDL_WAIT = 2;      // x is staged after the previous grid ends

template <typename TA, int MT, bool ALIGNED, class Pro, class Epi, int PDL>
__global__ void __launch_bounds__(DTHREADS, MT == 1 ? 4 : 2)
q8_decode_kernel(const TA* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, int M, int K, int N, int kper,
                 Pro pro, Epi epi) {
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

  if constexpr (PDL == PDL_WAIT)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage_rows<MT>(pro, xs, x, M, K, kbeg, kend, kper, tid);

  // warp w: A tile w; B: 8 MT rows of x, 16 of its K columns, two m8
  // tiles an ldmatrix.x4 (a last odd one by .x2, whose lanes 0-15 give
  // the addresses)
  const unsigned a_addr = a_tile_addr(wt, warp, lane);
  const unsigned b_addr = smem_u32(xs) +
      2 * (((lane & 7) + (MT >= 2 ? ((lane >> 4) & 1) * 8 : 0)) * xld +
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
      uint32_t a[4];
      ldsm_x4_trans(a, a_addr + 2 * kk * DWLD);
      const unsigned bk = b_addr + 2 * (it * DBK + kk);
#pragma unroll
      for (int p = 0; p < MT / 2; ++p) {   // A meets every m8 tile of x
        uint32_t b[4];
        ldsm_x4(b, bk + 2 * 16 * p * xld);
        mma_bf16(acc[2 * p], a, b[0], b[1]);
        mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
      if constexpr (MT % 2 == 1) {
        uint32_t b[2];
        ldsm_x2(b, bk + 2 * 16 * (MT / 2) * xld);
        mma_bf16(acc[MT - 1], a, b[0], b[1]);
      }
    }
  }
  if constexpr (PDL == PDL_TRIGGER)
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

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
  cluster_reduce_store(part, DBN, M, DBN, rank, nsplit, tid, DTHREADS, n0, N,
                       epi);
}

}  // namespace nwt

namespace {

using namespace nwt;

// set once per process, and per library (internal linkage: a script may
// load two builds of a source side by side)
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
// most DMAX_CLUSTER blocks a cluster, at most `max_slabs` slabs a block).
// ops/quant.py::k6_split is the same rule in Python.
void split_k(int K, int N, int bk, int max_slabs, int& split, int& per) {
  const int tiles = (N + DBN - 1) / DBN, slabs = (K + bk - 1) / bk;
  int want = (DSPLIT_TARGET * sm_count() + tiles - 1) / tiles;
  want = std::max(1, std::min(want, std::min(DMAX_CLUSTER, slabs)));
  per = std::min((slabs + want - 1) / want, max_slabs);
  split = (slabs + per - 1) / per;
}

// a plain launch for an unsplit grid without programmatic dependence (it
// costs the host less), else cudaLaunchKernelEx: a cluster of `split`
// blocks along x, and with `pdl` the programmatic stream serialization
template <typename Kern, typename... Args>
cudaError_t launch(Kern kernel, int split, int tiles, size_t smem,
                   cudaStream_t st, bool pdl, Args... args) {
  if (split > DMAX_CLUSTER || tiles > 65535) return cudaErrorInvalidValue;
  if (split == 1 && !pdl) {
    kernel<<<dim3(1, tiles), DTHREADS, smem, st>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, tiles);
  cfg.blockDim = dim3(DTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int na = 0;
  if (split > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = split;
    attr[na].val.clusterDim.y = 1;
    attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (pdl) {
    attr[na].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[na].val.programmaticStreamSerializationAllowed = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the kernel's attributes, once per process: its largest shared memory
// and clusters past the portable 8 blocks
template <typename Kern>
cudaError_t prepare(Kern kernel, DeviceFlags& ready, size_t smem) {
  const int dev = current_device();
  if (ready.done(dev)) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready.mark(dev);
  return e;
}

// x (M <= 8 MT, K) rows through the row prologue `pro`, times the int8 (K,
// N) weight with scales s, each sum through the epilogue `epi`
template <typename TA, int MT, bool ALIGNED, int PDL = PDL_NONE, class Pro,
          class Epi>
cudaError_t launch_decode(const TA* x, const int8_t* w, const float* s,
                          int M, int K, int N, Pro pro, Epi epi,
                          cudaStream_t st, bool pdl = false) {
  static DeviceFlags ready;     // the kernel's attributes, once a device
  auto kernel = q8_decode_kernel<TA, MT, ALIGNED, Pro, Epi, PDL>;
  cudaError_t e = prepare(kernel, ready, decode_smem(MT, DXK_MAX));
  if (e != cudaSuccess) return e;
  int split, per;
  split_k(K, N, DBK, DXK_MAX / DBK, split, per);
  return launch(kernel, split, (N + DBN - 1) / DBN,
                decode_smem(MT, per * DBK), st, pdl, x, w, s, M, K, N,
                per * DBK, pro, epi);
}

}  // namespace
