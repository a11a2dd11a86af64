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
// Both kernels swap A and B: out^T = W^T x^T, the dequantized weight tile
// the 16-row A operand of mma.sync.m16n8k16 and the rows of x the n8 side.
// The weight side (WeightRing: a cp.async slab ring, dequantization on
// the integer and FMA pipes) and the decode kernel live in
// csrc/q8_decode.cuh, which K7 (csrc/fused_mlp_q8.cu) runs too; its note
// says how they are built.
//
// * Decode, M <= 16 (q8_decode_kernel; every decode step, B <= 8 rows in
//   serving): x's rows as they are, an f32 store. Bound by bytes: the
//   logit projection is 66 MB, 20 us at 3.35 TB/s.
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

#include "q8_decode.cuh"

namespace nwt {

constexpr int DECODE_ROWS = 16;        // M at which the prefill kernel starts
constexpr int PBK = 64;                // weight rows a prefill stage
constexpr int PSTAGES = 2;             // slabs in a prefill block's ring

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
  cluster_reduce_store(part, DBN, M, DBN, rank, nsplit, tid, DTHREADS, n0, N,
                       StoreF32{out});
}

}  // namespace nwt

namespace {

using namespace nwt;

template <typename T, int MT>
cudaError_t launch_prefill(const T* x, const int8_t* w, const float* s,
                           float* out, int M, int K, int N, cudaStream_t st) {
  static DeviceFlags ready;     // the kernel's attributes, once a device
  auto kernel = q8_prefill_kernel<T, MT>;
  cudaError_t e = prepare(kernel, ready, prefill_smem<T>(MT, true));
  if (e != cudaSuccess) return e;
  int split, per;
  split_k(K, N, PBK, 1 << 20, split, per);
  const int chunks = (M + 8 * MT - 1) / (8 * MT);
  return launch(kernel, split, (N + DBN - 1) / DBN * chunks,
                prefill_smem<T>(MT, split > 1), st, false, x, w, s, out, M, K,
                N, per * PBK);
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
  const RowsAsIs rows;
  const StoreF32 store{out};
  if (M <= 8)
    return aligned
               ? launch_decode<T, 1, true>(x, w, s, M, K, N, rows, store, st)
               : launch_decode<T, 1, false>(x, w, s, M, K, N, rows, store, st);
  return aligned
             ? launch_decode<T, 2, true>(x, w, s, M, K, N, rows, store, st)
             : launch_decode<T, 2, false>(x, w, s, M, K, N, rows, store, st);
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
