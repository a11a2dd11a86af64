// K4 and K5: the decoder's single-query cross-attention, one decode step,
// over the whole encoder context of one window.
//
//   K4 nwt_xattn_decode_bf16: packed bf16 layout, K pre-transposed (Dh, Tp),
//      V (Tp, Dh), positions >= t_real masked by index. Replaces
//      nobs_whisper_tpu/ops/attention_pallas.py::cross_attention_decode_bf16
//      (pallas_call at :189, kernel _xattn_bf16_kernel :159).
//   K5 nwt_xattn_decode_q8: int8 K (Dh, Tp) and V (Tp, Dh) with f32
//      per-position scales; a zero scale masks its position. Replaces
//      cross_attention_decode_q8 (pallas_call at :111, kernel _xattn_kernel
//      :73).
//
// Per (batch row, head), at the TPU kernels' rounding points:
//   K4: raw = bf16(q) . kT in f32; s = raw * dh^-0.5, -1e30 at t >= t_real;
//       p = exp(s - max) / sum in f32, normalised BEFORE the bf16 cast;
//       out = bf16(p) @ v, f32 accumulation.
//   K5: raw = bf16(q) . kq in f32 (int8 is exact in bf16);
//       s = (raw * ks) * dh^-0.5 where ks > 0, else -1e30; p as K4;
//       pv = bf16(p * vs); out = pv @ vq, f32 accumulation.
// (The encoder kernels K1/K3/K9 divide by the sum after the PV product;
// these divide before it, so they do not share that kernel.)
//
// What bounds them on an H100: bytes. A step reads each position's K and V
// once for one query: 2 x Dh multiply-adds per 2 x Dh elements. At
// large-v3-turbo (H = 20, Dh = 64, Tp = 1536, 1500 real) and B = 8, K4
// reads 61.4 MB of bf16 (about 18 us at 3.35 TB/s; 2.3 us at B = 1) and K5
// 33.5 MB of int8 and scales (about 10 us; 1.3 us at B = 1); the
// arithmetic is a few hundred MFLOP.
//
// K4: a thread-block cluster of C blocks per (batch row, head), each block
// a slice of S positions (a multiple of 8, at most K4_SPAN; the last
// slices may be short or empty). Where K5 stages its slice of K whole and
// reads V from L2, K4's bf16 slice (twice K5's bytes) streams through a
// ring of K4_STAGES stages of 8 KB in shared memory, on bulk copies that
// one warp of the block issues: first K, R rows of the slice a stage (one
// copy a row, the slice's real positions), then V, 64 rows (Dh 64) a
// stage (one copy); 128 compute threads release each stage with an
// mbarrier arrival, and the copying warp refills it. So a block's shared
// memory is the ring and the scores row (S x 4 bytes), ~30 KB, and five
// blocks share an SM. At B >= 8 the time follows how evenly the bytes
// fall over the SMs (blocks on an SM that holds more of them finish
// later: PERF.md), so the plan (k4_plan) splits until the grid has
// K4_TARGET blocks an SM, slices no shorter than K4_MIN_SLICE, in one
// wave: at turbo B = 1 C = 8 (160 blocks of 192 positions, the whole
// slice on the copy engine at entry), B = 8 C = 2 (320 blocks, 2-3 an
// SM), B = 16 C = 2 (640 blocks, 4-5 an SM, where C = 1 puts 1.24x the
// mean bytes on the SMs that hold 3). Clusters of 4 do not fit one wave
// at B = 8 (the card holds 154 of them at once). Then:
//   (1) scores a K stage at a time: a thread keeps the sums of its words
//       (4 positions each) over every stage in registers; where the words
//       leave threads over, G groups share each stage's rows and their
//       sums are added in order at the end; positions at or past t_real
//       are never loaded (a slice wholly past it loads nothing: max
//       -1e30, sum 0, partial output 0);
//   (2) the max and the sum exchanged over the cluster as in K5 (pushes
//       into the peers' shared memory, a remote mbarrier arrival each),
//       then p / sum and its bf16 cast in place, while the ring's first V
//       boxes land;
//   (3) PV a V box at a time from shared memory, a thread 8 columns and
//       every TL-th row, summed by shuffles and across warps in a fixed
//       order; the partial outputs pushed to their owners and added in
//       rank order, as K5.
// What bounds it on an H100: bytes (K and V of the real positions once):
// at B = 8 and 16 it reads at 2.3-2.7 TB/s, faster than torch.sum over as
// many bytes (PERF.md); at B = 1 the chain of latencies of one block
// (loads, three exchanges).
//
// K5: a thread-block cluster of C blocks per (batch row, head), each block
// a slice of S positions (a multiple of 16; the last slices may be short
// or empty). C (1-16, a power of two) is chosen from B x H and the SM
// count so that the grid has at least K5_TARGET blocks an SM, and the
// slice small enough that K5_RESIDENT blocks share an SM (k5_plan): at
// turbo B = 1 that is C = 8 (160 blocks of 192 positions), at B = 8 C = 2
// (320 blocks of 768, 62 KB each, three an SM: one wave). A block starts
// its slice on the copy engine at entry: K as 2-D TMA boxes of Dh rows by
// up to 256 positions, each box on its own mbarrier, so a thread starts on
// its words as soon as their box lands (K by cp.async measured slower at
// every batch); the two scale rows by bulk copies; and, once its K has
// landed, V by a bulk prefetch into L2 (staged in shared memory too, V
// made the B = 8 grid two waves; issued with K, it took device memory's
// rate from the K the scores wait for). Then:
//   (1) scores from shared memory, a thread 4 positions (one word of each
//       K row; short slices split the Dh rows over 2 or 4 thread groups
//       whose sums are added in order), int8 widened by a byte permute and
//       one exact f32 subtraction (no I2F, a quarter-rate instruction);
//       the block max;
//   (2) every block pushes its max into a slot of every block of the
//       cluster (st.shared::cluster) and arrives on that block's mbarrier;
//       each block takes the max of its own slots (max is exact in any
//       order). exp(s - max) and a local sum in a fixed order, pushed the
//       same way and added in rank order, the same in every block; then
//       p / sum and bf16(p * vs) in place, so the bf16 cast sees the
//       normalised p as the TPU kernel's does (flash decoding's rescaling
//       of partial outputs afterwards would move that rounding point);
//   (3) PV with V from L2 in 16-byte words, four positions' loads in
//       flight, a thread 16 columns and every TL-th position, summed by
//       shuffles and across warps in a fixed order; each block pushes its
//       partial of element c to the block that owns c, which adds the C
//       partials in rank order and writes its Dh / C elements once. No
//       block reads another's shared memory, so none waits for the others
//       to leave.
// Every sum is taken in a fixed order, so two calls give the same bits. A
// slice whose positions are all masked has max -1e30 and, if every slice
// is, p comes out uniform, as the plain version's.
// What holds it above its byte bound (PERF.md, scripts/
// torch_xattn_variants.py --trace): at B = 1 a chain of latencies (a
// block lives ~15,000 cycles: the loads' issue and arrival, three
// exchanges of ~1,500 cycles each, mostly waiting for the slowest block
// of the cluster, and PV's L2 reads); at B = 8 the loads and the compute
// of a block do not overlap, and PV reads V a second time, from L2.

#include <algorithm>
#include <climits>
#include <initializer_list>
#include <mutex>

#include "common.cuh"
#include "hopper.cuh"

namespace nwt {

// ---------------------------------------------------------------------------
// K5: a cluster per (batch row, head), int8 K/V
// ---------------------------------------------------------------------------

constexpr int K5_THREADS = 256;
constexpr int K5_WARPS = K5_THREADS / 32;
constexpr int K5_MAX_C = 16;          // blocks a cluster (non-portable above 8)
constexpr int K5_STEP = 16;           // a slice is a multiple of 16 positions
constexpr int K5_BOX = 256;           // positions a TMA box of K at most
constexpr int K5_MAX_BOX = 16;        // boxes a slice at most
constexpr int K5_TARGET = 1;          // blocks an SM the split aims at
constexpr int K5_RESIDENT = 2;        // blocks an SM a slice must leave room for
constexpr int K5_FORCE_C = 0;         // a fixed C (ablations); 0: the plan's
constexpr int K5_PV_LOADS = 4;        // V's 16-byte loads a thread keeps in flight
constexpr int K5_SMEM_MAX = 232448;   // shared memory a block can have (227 KB)
// floats of the score groups' partial sums: G groups of S / 4 words cover
// at most the block's threads, so G S <= 4 K5_THREADS
constexpr int K5_PK = 4 * K5_THREADS;

// A slice of s positions as TMA boxes of K (Dh rows each): as few boxes of
// at most K5_BOX positions as cover it, all of one width, a multiple of 16
// (the last box may reach past the slice)
__host__ __device__ constexpr int k5_boxes(int s) {
  return (s / K5_STEP + K5_BOX / K5_STEP - 1) / (K5_BOX / K5_STEP);
}
__host__ __device__ constexpr int k5_box_width(int s) {
  return (s / K5_STEP + k5_boxes(s) - 1) / k5_boxes(s) * K5_STEP;
}

// The block's shared memory, in order: the mbarriers (one a K box, the
// scales', and the three exchanges'); the warps' partial outputs; the
// score groups' partial sums; q (Dh f32); the exchange slots that the
// cluster's blocks write into: their maxima, their sums, and their partial
// outputs of the Dh / C elements this block owns; the warp maxima and
// sums; then the K boxes (Dh rows of the box width each), the key scales
// (then scores, p, pv in place) and the value scales. V is not staged: it
// is prefetched into L2 and read from there.
__host__ __device__ constexpr int k5_head(int dh) {
  return 8 * (K5_MAX_BOX + 4) + 4 * K5_WARPS * dh + 4 * K5_PK + 4 * dh +
         4 * 2 * K5_MAX_C + 4 * dh + 4 * K5_WARPS;
}
__host__ __device__ constexpr int k5_head_aligned(int dh) {
  return (k5_head(dh) + 127) & ~127;
}
constexpr size_t k5_smem(int dh, int s) {
  return (size_t)k5_head_aligned(dh) +
         (size_t)dh * k5_boxes(s) * k5_box_width(s) + (size_t)8 * s;
}

struct K5Args {
  const bf16* q;         // (BH, Dh)
  const int8_t* k;       // (BH, Dh, Tp)
  const float* ks;       // (BH, Tp)
  const int8_t* v;       // (BH, Tp, Dh)
  const float* vs;       // (BH, Tp)
  float* out;            // (BH, Dh)
  int Tp, S;
  float scale;
};

// byte j of w ^ 0x80808080 as the f32 2^23 + 128 + (int8) byte j of w, by
// one byte permute; less 2^23 + 128, the int8 value, exactly
template <int J>
__device__ __forceinline__ float s8_at(uint32_t wx) {
  return __fsub_rn(__uint_as_float(__byte_perm(wx, 0x4B000000u,
                                               J | 0x7540)),
                   8388736.0f);
}

// `bytes` (a multiple of 16, 16-byte aligned) of device memory into L2
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   reinterpret_cast<uint64_t>(src)),
               "r"(bytes)
               : "memory");
}

// v into block `rank`'s float at this block's address p, then one arrival
// on block `rank`'s mbarrier at this block's address bar, released at
// cluster scope (the store is seen by whoever sees the arrival)
__device__ __forceinline__ void push_f32(float* p, float v, uint32_t bar,
                                         unsigned rank) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(
                   cluster_addr(smem_u32(p), rank)),
               "f"(v)
               : "memory");
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// until the mbarrier's phase 0 has completed, acquiring at cluster scope
// what the arrivals released (traps as mbar_wait does)
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// acc[j] += pv * (int8) byte j of the 16-byte word u, j = 0 .. 15
__device__ __forceinline__ void pv16(float (&acc)[16], uint4 u, float pv) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                         u.z ^ 0x80808080u, u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[4 * i] = fmaf(pv, s8_at<0>(w[i]), acc[4 * i]);
    acc[4 * i + 1] = fmaf(pv, s8_at<1>(w[i]), acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(pv, s8_at<2>(w[i]), acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(pv, s8_at<3>(w[i]), acc[4 * i + 3]);
  }
}

// phase boundaries of a block, for scripts/torch_xattn_variants.py --trace
// (nothing in the port's build)
#ifndef K5_MARK
#define K5_MARK(i)
#endif

template <int DH>
__global__ void __launch_bounds__(K5_THREADS)
xattn_q8_kernel(const __grid_constant__ CUtensorMap kmap, K5Args a) {
  K5_MARK(0);
  constexpr int CG = DH / 16;             // 16-column groups of V
  constexpr int TL = K5_THREADS / CG;     // position lanes of V
  static_assert(CG <= 32 && DH % 32 == 0 && TL * CG == K5_THREADS, "tiling");
  extern __shared__ __align__(128) uint8_t sm[];
  const uint32_t bar_k = smem_u32(sm);                // [K5_MAX_BOX]
  const uint32_t bar_s = bar_k + 8 * K5_MAX_BOX;      // the scales
  const uint32_t bar_max = bar_s + 8, bar_sum = bar_s + 16,
                 bar_part = bar_s + 24;               // the exchanges
  float* opart = reinterpret_cast<float*>(sm + 8 * (K5_MAX_BOX + 4));
  float* pk = opart + K5_WARPS * DH;                  // [G][S / 4] float4
  float* qs = pk + K5_PK;
  float* xmax = qs + DH;                  // [C]: each block's max
  float* xsum = xmax + K5_MAX_C;          // [C]: each block's sum
  float* xpart = xsum + K5_MAX_C;         // [C][Dh / C]: partial outputs
  float* wred = xpart + DH;               // [K5_WARPS]
  int8_t* kt = reinterpret_cast<int8_t*>(sm + k5_head_aligned(DH));
  const int S = a.S, Tp = a.Tp;
  const int nbox = k5_boxes(S), bw = k5_box_width(S);
  float* sc = reinterpret_cast<float*>(kt + DH * nbox * bw);   // ks, s, p, pv
  float* vsc = sc + S;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int t0 = rank * S, n = max(0, min(S, Tp - t0));
  const size_t row0 = (size_t)bh * Tp + t0;
  const float qv = tid < DH ? __bfloat162float(a.q[(size_t)bh * DH + tid])
                            : 0.f;   // its latency under the setup

  if (tid == 0) {
    for (int i = 0; i < nbox; ++i) mbar_init(bar_k + 8 * i, 1);
    mbar_init(bar_s, 1);
    mbar_init(bar_max, nc);
    mbar_init(bar_sum, nc);
    mbar_init(bar_part, DH);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the peers may signal this block's exchange barriers once every block
  // has passed this arrival (its wait is just before the first push)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (n > 0) {
    if (tid == 0) {   // the slice on the copy engine, V into L2
      mbar_expect_tx(bar_s, 8 * n);
      bulk_load(smem_u32(sc), a.ks + row0, 4 * n, bar_s);
      bulk_load(smem_u32(vsc), a.vs + row0, 4 * n, bar_s);
      for (int i = 0; i < nbox && i * bw < n; ++i) {
        mbar_expect_tx(bar_k + 8 * i, DH * bw);
        tma_load(smem_u32(kt + i * DH * bw), &kmap, t0 + i * bw, bh * DH,
                 bar_k + 8 * i);
      }
    }
  }
  if (tid < DH) qs[tid] = qv;
  __syncthreads();
  K5_MARK(1);
  // V into L2 once the block's K has landed: issued with K, V took half
  // the device memory's rate from the K the scores wait for
  if (n > 0 && tid == K5_THREADS - 1) {
    mbar_wait(bar_k + 8 * ((n - 1) / bw), 0);
    prefetch_l2(a.v + row0 * DH, DH * n);
  }
  if (n > 0) mbar_wait(bar_s, 0);
  K5_MARK(2);

  // (1) scores: word w holds positions 4w .. 4w + 3 of the slice, in box
  // 4w / bw. Where the threads cover the words G = 4 or 2 times over
  // (short slices), group g sums rows g Dh / G .. of K into pk and the
  // groups' sums are added in order after; else a thread sums all Dh rows
  // of its words. A thread waits for its own word's box only.
  float mx = __int_as_float(0xff800000u);   // -inf
  {
    const int nw = S / 4;
    const int G = nw * 4 <= K5_THREADS ? 4 : nw * 2 <= K5_THREADS ? 2 : 1;
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(kt);
    float4* s4 = reinterpret_cast<float4*>(sc);
    float4* p4 = reinterpret_cast<float4*>(pk);
    auto dot = [&](int w, int d0, int d1) {
      const int box = 4 * w / bw;
      mbar_wait(bar_k + 8 * box, 0);
      const uint32_t* row = k32 + box * DH * (bw / 4) + (w - box * (bw / 4));
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll 16
      for (int d = d0; d < d1; ++d) {
        const uint32_t wx = row[d * (bw / 4)] ^ 0x80808080u;
        const float qd = qs[d];
        acc0 = fmaf(qd, s8_at<0>(wx), acc0);   // exact products
        acc1 = fmaf(qd, s8_at<1>(wx), acc1);
        acc2 = fmaf(qd, s8_at<2>(wx), acc2);
        acc3 = fmaf(qd, s8_at<3>(wx), acc3);
      }
      return make_float4(acc0, acc1, acc2, acc3);
    };
    auto score = [&](int w, float4 acc) {
      const float4 kk = s4[w];
      const float raw[4] = {acc.x, acc.y, acc.z, acc.w};
      const float ksv[4] = {kk.x, kk.y, kk.z, kk.w};
      float s[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = ksv[j] > 0.f ? __fmul_rn(__fmul_rn(raw[j], ksv[j]), a.scale)
                            : -1e30f;
        mx = fmaxf(mx, s[j]);
      }
      s4[w] = make_float4(s[0], s[1], s[2], s[3]);
    };
    if (G == 1) {
      for (int w = tid; w < n / 4; w += K5_THREADS) score(w, dot(w, 0, DH));
    } else {
      const int g = tid / nw, w = tid % nw;
      if (g < G && w < n / 4)
        p4[g * nw + w] = dot(w, g * (DH / G), (g + 1) * (DH / G));
      __syncthreads();
      for (int w = tid; w < n / 4; w += K5_THREADS) {
        float4 acc = p4[w];
        for (int i = 1; i < G; ++i) {
          const float4 t = p4[i * nw + w];
          acc = make_float4(__fadd_rn(acc.x, t.x), __fadd_rn(acc.y, t.y),
                            __fadd_rn(acc.z, t.z), __fadd_rn(acc.w, t.w));
        }
        score(w, acc);
      }
    }
  }
  mx = warp_max(mx);
  if (lane == 0) wred[warp] = mx;
  __syncthreads();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  K5_MARK(3);
  // (2) the block's max into every block's slot `rank` (max is exact in any
  // order), then the cluster max from this block's own slots
  if (warp == 0) {
    float m = wred[0];
    for (int i = 1; i < K5_WARPS; ++i) m = fmaxf(m, wred[i]);
    if (lane < nc) push_f32(xmax + rank, m, bar_max, lane);
  }
  mbar_wait_cluster(bar_max);
  K5_MARK(4);
  float gmax = xmax[0];
  for (int r = 1; r < nc; ++r) gmax = fmaxf(gmax, xmax[r]);
  float sum = 0.f;
  for (int p = tid; p < n; p += K5_THREADS) {
    const float e = expf(__fsub_rn(sc[p], gmax));
    sc[p] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  __syncthreads();   // every warp has read wred's maxima
  if (lane == 0) wred[warp] = sum;
  __syncthreads();
  K5_MARK(5);
  if (warp == 0) {   // the block's sum, in warp order, to every block
    float r = wred[0];
    for (int i = 1; i < K5_WARPS; ++i) r = __fadd_rn(r, wred[i]);
    if (lane < nc) push_f32(xsum + rank, r, bar_sum, lane);
  }
  mbar_wait_cluster(bar_sum);
  float gsum = 0.f;
  for (int r = 0; r < nc; ++r)   // in rank order, the same in every block
    gsum = __fadd_rn(gsum, xsum[r]);
  for (int p = tid; p < n; p += K5_THREADS)
    sc[p] = __bfloat162float(__float2bfloat16_rn(
        __fmul_rn(__fdiv_rn(sc[p], gsum), vsc[p])));
  __syncthreads();
  K5_MARK(6);

  // (3) the block's partial out = pv @ V, V from L2 in 16-byte words,
  // K5_PV_LOADS positions' loads in flight: thread (tl, cg) owns columns
  // 16 cg .. 16 cg + 15 and positions tl, tl + TL, ...
  const int cg = tid % CG, tl = tid / CG;
  float o[16] = {};
  {
    const uint4* v16 = reinterpret_cast<const uint4*>(a.v + row0 * DH) + cg;
    for (int p0 = tl; p0 < n; p0 += K5_PV_LOADS * TL) {
      uint4 u[K5_PV_LOADS];
      float pv[K5_PV_LOADS];
#pragma unroll
      for (int j = 0; j < K5_PV_LOADS; ++j) {
        const int p = p0 + j * TL;
        u[j] = p < n ? __ldg(v16 + p * CG) : make_uint4(0u, 0u, 0u, 0u);
        pv[j] = p < n ? sc[p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < K5_PV_LOADS; ++j) pv16(o, u[j], pv[j]);
    }
  }
#pragma unroll
  for (int off = CG; off < 32; off <<= 1)   // the warp's position lanes
#pragma unroll
    for (int j = 0; j < 16; ++j)
      o[j] = __fadd_rn(o[j], __shfl_xor_sync(0xffffffffu, o[j], off));
  if (lane < CG)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(opart + warp * DH + 16 * lane + 4 * j) =
          make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
  __syncthreads();
  K5_MARK(7);
  // element c's partial, summed over the warps in order, into slot (rank,
  // c mod E) of block c / E, which owns it (E = Dh / C); each owner adds
  // its slots in rank order and writes its E elements once
  const int E = DH / nc;
  if (tid < DH) {
    float r = opart[tid];
    for (int i = 1; i < K5_WARPS; ++i) r = __fadd_rn(r, opart[i * DH + tid]);
    push_f32(xpart + rank * E + tid % E, r, bar_part, tid / E);
  }
  mbar_wait_cluster(bar_part);
  K5_MARK(8);
  if (tid < E) {
    float r = 0.f;
    for (int q = 0; q < nc; ++q) r = __fadd_rn(r, xpart[q * E + tid]);
    a.out[(size_t)bh * DH + rank * E + tid] = r;
  }
  K5_MARK(9);
}

// ---------------------------------------------------------------------------
// K4: a cluster per (batch row, head), packed bf16, K and V through a ring
// ---------------------------------------------------------------------------

constexpr int K4_THREADS = 128;       // compute threads; one more warp copies
constexpr int K4_WARPS = K4_THREADS / 32;
constexpr int K4_MAX_C = 16;          // blocks a cluster (non-portable above 8)
constexpr int K4_STEP = 8;            // a slice is a multiple of 8 positions
constexpr int K4_SPAN = 1024;         // positions a slice at most
constexpr int K4_MIN_SLICE = 192;     // positions a split leaves a slice at least
constexpr int K4_STAGE = 8192;        // bytes a ring stage
constexpr int K4_STAGES = 3;          // stages of the ring
constexpr int K4_TARGET = 2;          // blocks an SM the split aims at
constexpr int K4_FORCE_C = 0;         // a fixed C (ablations); 0: the plan's
constexpr int K4_SMEM_MAX = 232448;   // shared memory a block can have (227 KB)
static_assert(K4_SMEM_MAX == K5_SMEM_MAX, "one limit for both kernels");
// words (4 positions) a thread's scores keep in registers: a slice's words
// over the block's threads
constexpr int K4_WORDS = K4_SPAN / (4 * K4_THREADS);
// floats of the score groups' partial sums (G groups of a slice's words
// cover at most the block's threads, a float4 each), later of the warps'
// partial outputs (K4_WARPS x Dh)
constexpr int K4_PK = 4 * K4_THREADS;
static_assert(K4_WARPS * 128 <= K4_PK, "the warps' partial outputs");

// rows of K a stage holds for slices of s <= K4_SPAN positions: the
// largest power of two of rows of s bf16 in K4_STAGE bytes, at most Dh
__host__ __device__ constexpr int k4_rows(int s, int dh) {
  int r = 1;
  while (2 * r <= dh && 2 * r * 2 * s <= K4_STAGE) r *= 2;
  return r;
}
// positions of V a stage holds: as many rows of Dh (64 at Dh 64)
__host__ __device__ constexpr int k4_vbox(int dh) {
  return K4_STAGE / (2 * dh);
}

// The block's shared memory, in order: the mbarriers (two a stage, full
// and empty; the three exchanges'; one spare for alignment); the score
// groups' partial sums (then the warps' partial outputs); q (Dh f32); the
// exchange slots that the cluster's blocks write into: their maxima, their
// sums, and their partial outputs of the Dh / C elements this block owns;
// the warp maxima and sums; then the ring's stages and the scores row
// (then p).
__host__ __device__ constexpr int k4_head(int dh) {
  return 8 * (2 * K4_STAGES + 4) + 4 * K4_PK + 4 * dh + 4 * 2 * K4_MAX_C +
         4 * dh + 4 * K4_WARPS;
}
__host__ __device__ constexpr int k4_head_aligned(int dh) {
  return (k4_head(dh) + 127) & ~127;
}
constexpr size_t k4_smem(int dh, int s) {
  return (size_t)k4_head_aligned(dh) + (size_t)K4_STAGES * K4_STAGE +
         (size_t)4 * s;
}

struct K4Args {
  const bf16* q;         // (BH, Dh)
  const bf16* k;         // (BH, Dh, Tp)
  const bf16* v;         // (BH, Tp, Dh)
  float* out;            // (BH, Dh)
  int Tp, S, t_real;
  float scale;
};

// phase boundaries of a block, for scripts/torch_xattn_variants.py --trace
// (nothing in the port's build)
#ifndef K4_MARK
#define K4_MARK(i)
#endif

// consumer-only barrier: the K4_THREADS compute threads (named barrier 1;
// the copying warp has left the common path)
__device__ __forceinline__ void k4_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(K4_THREADS) : "memory");
}

// (registers for five blocks an SM, as the plan's one wave needs)
template <int DH>
__global__ void __launch_bounds__(K4_THREADS + 32, 5)
xattn_bf16_kernel(K4Args a) {
  K4_MARK(0);
  constexpr int DG = DH / 8;              // 8-column groups of V
  constexpr int TL = K4_THREADS / DG;     // position lanes of V
  static_assert(DG <= 32 && TL * DG == K4_THREADS, "tiling");
  extern __shared__ __align__(128) uint8_t sm[];
  const uint32_t bar_full = smem_u32(sm);             // [K4_STAGES]
  const uint32_t bar_empty = bar_full + 8 * K4_STAGES;  // [K4_STAGES]
  const uint32_t bar_max = bar_empty + 8 * K4_STAGES, bar_sum = bar_max + 8,
                 bar_part = bar_max + 16;             // the exchanges
  float* red = reinterpret_cast<float*>(sm + 8 * (2 * K4_STAGES + 4));
  float* qs = red + K4_PK;
  float* xmax = qs + DH;                  // [C]: each block's max
  float* xsum = xmax + K4_MAX_C;          // [C]: each block's sum
  float* xpart = xsum + K4_MAX_C;         // [C][Dh / C]: partial outputs
  float* wred = xpart + DH;               // [K4_WARPS]
  uint8_t* ring = sm + k4_head_aligned(DH);
  float* sc = reinterpret_cast<float*>(ring + K4_STAGES * K4_STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int S = a.S, t0 = rank * S;
  // the slice's positions below t_real (a slice at or past it loads
  // nothing), as one stream through the ring: K's Dh / R stages of R rows
  // (the slice's n real positions of each, rounded up to 8: one bulk copy
  // a row), then V's boxes of bv rows (one bulk copy a box)
  const int n = max(0, min(S, a.t_real - t0)), nrow = (n + 7) & ~7;
  const int R = k4_rows(S, DH), nk = n > 0 ? DH / R : 0;
  const int bv = k4_vbox(DH), nv = (n + bv - 1) / bv;
  const bf16* ks = a.k + (size_t)bh * DH * a.Tp + t0;
  const bf16* vs = a.v + ((size_t)bh * a.Tp + t0) * DH;
  const float qv = tid < DH ? __bfloat162float(a.q[(size_t)bh * DH + tid])
                            : 0.f;   // its latency under the setup
  // item i of the stream into stage i mod K4_STAGES, by the lanes of the
  // copying warp: K rows i R .. i R + R - 1 (S positions apart in the
  // stage), or V box i - nk
  auto issue = [&](int i) {
    const int st = i % K4_STAGES;
    const uint32_t dst = smem_u32(ring + st * K4_STAGE),
                   bar = bar_full + 8 * st;
    if (i < nk) {
      if (lane == 0) mbar_expect_tx(bar, 2 * R * nrow);
      __syncwarp();
      for (int r = lane; r < R; r += 32)
        bulk_load(dst + 2 * r * S, ks + (size_t)(i * R + r) * a.Tp,
                  2 * nrow, bar);
    } else if (lane == 0) {
      const int j = i - nk, rows = min(bv, n - j * bv);
      mbar_expect_tx(bar, 2 * DH * rows);
      bulk_load(dst, vs + (size_t)j * bv * DH, 2 * DH * rows, bar);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < K4_STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, K4_WARPS);
    }
    mbar_init(bar_max, nc);
    mbar_init(bar_sum, nc);
    mbar_init(bar_part, DH);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the peers may signal this block's exchange barriers once every block
  // has passed this arrival (its wait is just before the first push)
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (warp == K4_WARPS) {
    // the copying warp: the stream's items into the ring, each once every
    // compute warp has released the stage's previous item; then it leaves
    for (int i = 0; i < nk + nv; ++i) {
      if (i >= K4_STAGES)
        mbar_wait(bar_empty + 8 * (i % K4_STAGES), (i / K4_STAGES - 1) & 1);
      issue(i);
    }
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    return;
  }
  // a compute warp is done with item i's stage
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (i % K4_STAGES));
  };
  if (tid < DH) qs[tid] = qv;
  k4_sync();
  K4_MARK(1);

  // (1) scores, R rows of K a stage. Word w holds positions 4w .. 4w + 3
  // of the slice. The threads form G groups (as many as the W words leave
  // threads for, each taking R / G of a stage's rows); thread u of a group
  // keeps the sums of words u, u + K4_THREADS / G, ... in registers over every
  // stage, and the groups' sums are added in order at the end. Each warp
  // releases a stage to the copying warp once it has read it.
  float mx = -1e30f;
  {
    const int W = (n + 3) / 4;
    int G = 1;
    while (2 * G <= R && 2 * G * W <= K4_THREADS) G *= 2;
    const int TG = K4_THREADS / G, g = tid / TG, u = tid % TG, RG = R / G;
    float4 acc[K4_WORDS];
#pragma unroll
    for (int k = 0; k < K4_WORDS; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < nk; ++i) {
      const int st = i % K4_STAGES;
      // every thread waits (a warp with no words must not release a stage
      // before its item has landed)
      mbar_wait(bar_full + 8 * st, (i / K4_STAGES) & 1);
      if (u < W) {
        const uint2* kr =
            reinterpret_cast<const uint2*>(ring + st * K4_STAGE) + u;
        for (int r = g * RG; r < (g + 1) * RG; ++r) {
          const float qd = qs[i * R + r];
#pragma unroll
          for (int k = 0; k < K4_WORDS; ++k)
            if (u + k * TG < W) {
              const uint2 x = kr[r * (S / 4) + k * TG];
              acc[k].x = fmaf(qd, __uint_as_float(x.x << 16), acc[k].x);
              acc[k].y = fmaf(qd, __uint_as_float(x.x & 0xffff0000u), acc[k].y);
              acc[k].z = fmaf(qd, __uint_as_float(x.y << 16), acc[k].z);
              acc[k].w = fmaf(qd, __uint_as_float(x.y & 0xffff0000u), acc[k].w);
            }
        }
      }
      release(i);
    }
    if (G > 1) {   // one word a thread (G W <= 256): the groups' sums in order
      float4* pk = reinterpret_cast<float4*>(red);
      if (u < W) pk[g * W + u] = acc[0];
      k4_sync();
      if (tid < W) {
        acc[0] = pk[tid];
        for (int j = 1; j < G; ++j) {
          const float4 t = pk[j * W + tid];
          acc[0] = make_float4(__fadd_rn(acc[0].x, t.x), __fadd_rn(acc[0].y, t.y),
                               __fadd_rn(acc[0].z, t.z), __fadd_rn(acc[0].w, t.w));
        }
      }
    }
    float4* s4 = reinterpret_cast<float4*>(sc);
#pragma unroll
    for (int k = 0; k < K4_WORDS; ++k) {
      const int w = G > 1 ? (k == 0 ? tid : W) : tid + k * K4_THREADS;
      if (w < W) {
        const float raw[4] = {acc[k].x, acc[k].y, acc[k].z, acc[k].w};
        float sv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sv[j] = 4 * w + j < n ? __fmul_rn(raw[j], a.scale) : -1e30f;
          mx = fmaxf(mx, sv[j]);
        }
        s4[w] = make_float4(sv[0], sv[1], sv[2], sv[3]);
      }
    }
  }
  K4_MARK(2);
  mx = warp_max(mx);
  if (lane == 0) wred[warp] = mx;
  k4_sync();
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  K4_MARK(3);
  // (2) the block's max into every block's slot `rank` (max is exact in any
  // order), then the cluster max from this block's own slots
  if (warp == 0) {
    float m = wred[0];
    for (int i = 1; i < K4_WARPS; ++i) m = fmaxf(m, wred[i]);
    if (lane < nc) push_f32(xmax + rank, m, bar_max, lane);
  }
  mbar_wait_cluster(bar_max);
  K4_MARK(4);
  float gmax = xmax[0];
  for (int r = 1; r < nc; ++r) gmax = fmaxf(gmax, xmax[r]);
  float sum = 0.f;
  for (int p = tid; p < n; p += K4_THREADS) {
    const float e = expf(__fsub_rn(sc[p], gmax));
    sc[p] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  k4_sync();   // every warp has read wred's maxima
  if (lane == 0) wred[warp] = sum;
  k4_sync();
  K4_MARK(5);
  if (warp == 0) {   // the block's sum, in warp order, to every block
    float r = wred[0];
    for (int i = 1; i < K4_WARPS; ++i) r = __fadd_rn(r, wred[i]);
    if (lane < nc) push_f32(xsum + rank, r, bar_sum, lane);
  }
  mbar_wait_cluster(bar_sum);
  float gsum = 0.f;
  for (int r = 0; r < nc; ++r)   // in rank order, the same in every block
    gsum = __fadd_rn(gsum, xsum[r]);
  for (int p = tid; p < n; p += K4_THREADS)
    sc[p] = __bfloat162float(__float2bfloat16_rn(__fdiv_rn(sc[p], gsum)));
  k4_sync();
  K4_MARK(6);

  // (3) the block's partial out = bf16(p) @ V, a V box at a time: thread
  // (tl, dg) owns columns 8 dg .. 8 dg + 7 and the box's rows tl, tl + TL,
  // ...; summed by shuffles and across warps in a fixed order
  const int dg = tid % DG, tl = tid / DG;
  float o[8] = {};
  for (int j = 0; j < nv; ++j) {
    const int i = nk + j, st = i % K4_STAGES, rows = min(bv, n - j * bv);
    mbar_wait(bar_full + 8 * st, (i / K4_STAGES) & 1);
    const uint4* vr = reinterpret_cast<const uint4*>(ring + st * K4_STAGE) + dg;
    const float* pj = sc + j * bv;
    for (int r = tl; r < rows; r += TL) {
      const uint4 u = vr[r * DG];
      const float p = pj[r];
      const uint32_t wv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = fmaf(p, __uint_as_float(wv[k] << 16), o[2 * k]);
        o[2 * k + 1] =
            fmaf(p, __uint_as_float(wv[k] & 0xffff0000u), o[2 * k + 1]);
      }
    }
    release(i);
  }
#pragma unroll
  for (int off = DG; off < 32; off <<= 1)   // the warp's position lanes
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = __fadd_rn(o[k], __shfl_xor_sync(0xffffffffu, o[k], off));
  float* opart = red;                       // [K4_WARPS][Dh]
  if (lane < DG) {
    *reinterpret_cast<float4*>(opart + warp * DH + 8 * lane) =
        make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(opart + warp * DH + 8 * lane + 4) =
        make_float4(o[4], o[5], o[6], o[7]);
  }
  k4_sync();
  K4_MARK(7);
  // element c's partial, summed over the warps in order, into slot (rank,
  // c mod E) of block c / E, which owns it (E = Dh / C); each owner adds
  // its slots in rank order and writes its E elements once
  const int E = DH / nc;
  if (tid < DH) {
    float r = opart[tid];
    for (int i = 1; i < K4_WARPS; ++i) r = __fadd_rn(r, opart[i * DH + tid]);
    push_f32(xpart + rank * E + tid % E, r, bar_part, tid / E);
  }
  mbar_wait_cluster(bar_part);
  K4_MARK(8);
  if (tid < E) {
    float r = 0.f;
    for (int q = 0; q < nc; ++q) r = __fadd_rn(r, xpart[q * E + tid]);
    a.out[(size_t)bh * DH + rank * E + tid] = r;
  }
  K4_MARK(9);
}

}  // namespace nwt

namespace {

using namespace nwt;

// set once per process, and per library (internal linkage)
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

// K5's cluster size C (0 if no slice of at most 16 fits a block's shared
// memory) and slice S for BH (batch row, head) pairs: C doubles while the
// grid has fewer than K5_TARGET blocks an SM, or a block's slice leaves
// no room for K5_RESIDENT blocks an SM, up to K5_MAX_C and to half the
// 16-position chunks; S is the chunks over C, rounded up, in positions.
// ops/attention_pallas.py::k5_plan is the same rule in Python.
int k5_plan(int bh, int tp, int dh, int sms, int& S) {
  const int chunks = tp / K5_STEP;
  auto slice = [&](int c) { return (chunks + c - 1) / c * K5_STEP; };
  int c = K5_FORCE_C;
  if (c == 0) {
    c = 1;
    while (c < K5_MAX_C && 2 * c <= chunks &&
           ((long long)c * bh < (long long)K5_TARGET * sms ||
            k5_smem(dh, slice(c)) > (size_t)K5_SMEM_MAX / K5_RESIDENT))
      c *= 2;
  }
  S = slice(c);
  return k5_smem(dh, S) <= (size_t)K5_SMEM_MAX && k5_boxes(S) <= K5_MAX_BOX
             ? c
             : 0;
}

// K4's cluster size C (0 if the slice at C = K4_MAX_C, or at the forced C,
// is longer than K4_SPAN) and slice S for BH (batch row, head) pairs: C
// doubles while the slice is longer than K4_SPAN, or while the grid has
// fewer than K4_TARGET blocks an SM and halving the slice leaves at least
// K4_MIN_SLICE positions, up to K4_MAX_C and half the 8-position chunks;
// S is the chunks over C, rounded up, in positions.
// ops/attention_pallas.py::k4_plan is the same rule in Python.
int k4_plan(int bh, int tp, int sms, int& S) {
  const int chunks = tp / K4_STEP;
  auto slice = [&](int c) { return (chunks + c - 1) / c * K4_STEP; };
  int c = K4_FORCE_C;
  if (c == 0) {
    c = 1;
    while (c < K4_MAX_C && 2 * c <= chunks &&
           (slice(c) > K4_SPAN ||
            ((long long)c * bh < (long long)K4_TARGET * sms &&
             slice(2 * c) >= K4_MIN_SLICE)))
      c *= 2;
  }
  S = slice(c);
  return S <= K4_SPAN ? c : 0;
}

// K's tensor map for (K base, Tp, BH Dh rows, box width): encoded at the
// first call with that key and kept, since a decode step meets the same
// cross-KV layers again at every token (a map holds no data, so a key
// whose memory was freed and handed out again still maps it rightly)
struct K5MapEntry {
  const void* k;
  int tp, rows, bw;
  CUtensorMap map;
};
constexpr int K5_MAPS = 64;
K5MapEntry g_maps[K5_MAPS];
int g_nmaps = 0, g_next = 0;   // entries held; the next to replace
std::mutex g_maps_lock;

bool k5_map(CUtensorMap* out, const int8_t* k, int tp, int rows, int bw,
            int dh) {
  std::lock_guard<std::mutex> hold(g_maps_lock);
  for (int i = 0; i < g_nmaps; ++i) {
    const K5MapEntry& m = g_maps[i];
    if (m.k == k && m.tp == tp && m.rows == rows && m.bw == bw) {
      *out = m.map;
      return true;
    }
  }
  EncodeTiledFn enc = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)tp, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)tp};
  const cuuint32_t box[2] = {(cuuint32_t)bw, (cuuint32_t)dh};
  const cuuint32_t unit[2] = {1, 1};
  if (!enc ||
      enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(k), dims,
          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  g_maps[g_next] = {k, tp, rows, bw, *out};   // the oldest goes first
  g_next = (g_next + 1) % K5_MAPS;
  g_nmaps = std::min(g_nmaps + 1, K5_MAPS);
  return true;
}

// a grid of (c, BH) blocks in clusters of c along x, with `smem` bytes of
// dynamic shared memory; the kernel's attributes set at its first launch
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), bool& ready, int c, int BH,
                            int threads, size_t smem, cudaStream_t st,
                            const A&... args) {
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K4_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, BH);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int DH>
cudaError_t launch_k5(const K5Args& a, int BH, cudaStream_t st) {
  static bool ready = false;   // the kernel's attributes, once per process
  K5Args args = a;
  const int c = k5_plan(BH, a.Tp, DH, sm_count(), args.S);
  if (c == 0 || BH > 65535 || (long long)BH * DH > INT32_MAX)
    return cudaErrorInvalidValue;
  // K as (BH Dh rows, Tp bytes); a box is one slice box of Dh rows, the
  // zero fill past Tp is never used
  CUtensorMap kmap;
  if (!k5_map(&kmap, a.k, a.Tp, BH * DH, k5_box_width(args.S), DH))
    return cudaErrorInvalidValue;
  return launch_clusters(xattn_q8_kernel<DH>, ready, c, BH, K5_THREADS,
                         k5_smem(DH, args.S), st, kmap, args);
}

template <int DH>
cudaError_t launch_k4(const K4Args& a, int BH, cudaStream_t st) {
  static bool ready = false;   // the kernel's attributes, once per process
  K4Args args = a;
  const int c = k4_plan(BH, a.Tp, sm_count(), args.S);
  if (c == 0 || BH > 65535) return cudaErrorInvalidValue;
  return launch_clusters(xattn_bf16_kernel<DH>, ready, c, BH,
                         K4_THREADS + 32, k4_smem(DH, args.S), st, args);
}

}  // namespace

// K4. q (BH, Dh) bf16; kT (BH, Dh, Tp) and v (BH, Tp, Dh) bf16, Tp % 8 == 0,
// kT and v 16-byte aligned (the bulk copies; q is read as is),
// 0 < t_real <= Tp, dh in {32, 64, 128}. Writes out (BH, Dh) f32, every
// element once.
extern "C" int nwt_xattn_decode_bf16(const void* q, const void* kT,
                                     const void* v, void* out, int BH, int dh,
                                     int Tp, int t_real, float scale,
                                     void* stream) {
  if (BH <= 0 || Tp <= 0 || Tp % K4_STEP || t_real <= 0 || t_real > Tp)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {kT, v})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  K4Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(kT),
           static_cast<const bf16*>(v), static_cast<float*>(out), Tp, 0,
           t_real, scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch_k4<32>(a, BH, st);
    case 64: return (int)launch_k4<64>(a, BH, st);
    case 128: return (int)launch_k4<128>(a, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5. q (BH, Dh) bf16; kq (BH, Dh, Tp) and vq (BH, Tp, Dh) int8 with ks, vs
// (BH, Tp) f32, Tp % 16 == 0, every pointer 16-byte aligned, dh in {32,
// 64, 128}. Writes out (BH, Dh) f32, every element once.
extern "C" int nwt_xattn_decode_q8(const void* q, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, void* out, int BH, int dh,
                                   int Tp, float scale, void* stream) {
  if (BH <= 0 || Tp <= 0 || Tp % K5_STEP) return (int)cudaErrorInvalidValue;
  for (const void* p : {kq, ks, vq, vs})
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  K5Args a{static_cast<const bf16*>(q), static_cast<const int8_t*>(kq),
           static_cast<const float*>(ks), static_cast<const int8_t*>(vq),
           static_cast<const float*>(vs), static_cast<float*>(out), Tp, 0,
           scale};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dh) {
    case 32: return (int)launch_k5<32>(a, BH, st);
    case 64: return (int)launch_k5<64>(a, BH, st);
    case 128: return (int)launch_k5<128>(a, BH, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
