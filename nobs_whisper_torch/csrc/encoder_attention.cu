// Encoder self-attention: non-causal softmax attention per head, keys >=
// n_real masked. Three entry points share one attention kernel
// (attn_kernel, templated on the head width, the two int8 variants and the
// output type):
//
//   K1 nwt_encoder_attention_fused_qkv: LN1 -> per-row int8 quant -> int8
//      q/k/v projections -> attention, flat (B, T, d) layout; with the o
//      projection and the residual fused (NWT_ATTN_FUSED=2). Replaces
//      nobs_whisper_tpu/ops/encoder_attention.py::encoder_attention_fused_qkv
//      (pallas_call at :565, kernel _attn_kernel_btd_fused :370 with
//      _make_scores :203 and _make_pv :292).
//   K3 nwt_encoder_attention_btd (nwt_encoder_attention_btd_int8 for the
//      int8 variants): attention on projected bf16 q/k/v in the flat
//      (B, T, d) layout. Replaces encoder_attention_btd (pallas_call at
//      :185, kernel _attn_kernel_btd :105), the float bf16 encoder's default.
//   K9 nwt_encoder_attention_bhtd: the same on per-head (B, H, T, dh)
//      tensors. Replaces encoder_attention (pallas_call at :93, kernel
//      _attn_kernel :35), taken where heads do not pair into 128 lanes.
// fused_layer.cu (K12) calls K1's host function with the o projection fused.
//
// Bounds on an H100 at large-v3-turbo (T = 1536 padded, n_real = 1500,
// d = 1280, H = 20, dh = 64), per window and layer: QK^T and PV are
// 11.8 GFLOP bf16 over the real keys, about 12 us at the published bf16
// tensor-core peak; K3 and K9 move 4 x 3.9 MB of q/k/v/out, about 4.7 us, so
// they are compute-bound. K1 adds 15.1 G int8 operations in the
// projections (about 20 us in all; its bytes about 3.8 us), and 5.0 G more
// with the o projection fused. The int8 variants run QK^T or PV at the int8
// rate, twice bf16's.
//
// Design:
//   1. ln_quant_kernel (common.cuh, K1 only). The TPU kernel computes LN +
//      quant once per batch row into scratch that its later head-pair grid
//      steps reuse (encoder_attention.py:416-433). GPU blocks run in
//      parallel and in no order, so this is a separate pass writing int8
//      rows + scales.
//   2. qkv_gemm_kernel (common.cuh, shared with K10): the three
//      projections as one int8 mma.sync GEMM launch (grid.z picks q, k or
//      v). The epilogue dequantizes (acc * s_row * s_col + bias) and writes
//      bf16(q * dh^-0.5), bf16(k), bf16(v) -- exactly the operands the TPU
//      kernel feeds its bf16 dots; under int8 scores q stays f32 and
//      unscaled, as the TPU kernel quantizes it (:443, :455). The outputs
//      make one round trip through device memory (3 x B x T x d), which the
//      TPU kernel keeps in VMEM.
//   3. The int8 variants' preparation (int8_prep): q quantized per (row,
//      head), divided by its scale max(absmax, 1e-6) / 127; k and v per
//      (batch row, head), times the reciprocal of max(absmax over rows <
//      n_real, 1e-6) / 127 (:225-241, :306-322). The per-head absmax needs
//      every real row before any score: one pass takes it with atomicMax on
//      the float bits (non-negative floats order like their bit patterns,
//      so the result is exact and independent of order), a second
//      quantizes. The TPU kernel holds a head pair's whole K and V in VMEM
//      and takes the statistic there.
//   4. attn_kernel: one block per (64 query rows, head, batch row), one warp
//      per 16 query rows, mma.sync with f32 (bf16) or int32 (int8)
//      accumulation. Strides say where a head's rows lie, so one kernel
//      reads the flat layout (K1, K3) and the per-head one (K9). bf16 q
//      fragments are scaled while they are loaded: bf16(f32(q) * scale), the
//      TPU kernels' rounding (K1 passes 1.0, its q being scaled already).
//      K and V of one head at T = 1536 (2 x 196 KB at dh = 64) do not fit in
//      shared memory, and an online softmax would round bf16(p) or
//      round(p * 127) against a running max instead of the final one. So
//      two passes over 64-key tiles: the first finds the row max, the
//      second computes p = exp(s - max) exactly as the TPU kernels do and
//      accumulates the PV product. Tiles wholly past n_real are skipped
//      (their p is exactly 0); padded query rows see real keys only, so
//      their output is finite.
//      int8 scores: m16n8k32 on int8 q and k; the int32 dot over dh = 64
//      is exact, then s = f32(dot) * (sq * (sk * scale)). int8 PV: pq =
//      rint(p * 127) as int8, PV on m16n8k32 against int8 v, the
//      normaliser the integer sum of pq (exact), o = (f32(dot) / max(sum,
//      1)) * sv. The PV operand's key order inside each 32-key step is
//      permuted (key_slot) so that the probabilities, which the scores'
//      accumulator layout leaves two keys per 8-key group in each thread,
//      are the A fragment as they lie; the int32 sum does not depend on
//      the order.
//   5. K1 with the o projection (NWT_ATTN_FUSED=2): the attention writes
//      its normalised output in f32 (the TPU kernel requantizes the f32
//      pair tile, :466); ln_quant_kernel without LN quantizes each (row,
//      head pair) of 128 columns; fc2_gemm_kernel (common.cuh) runs the o
//      projection from f32(x) + bo, flushing its int32 accumulator with
//      each 128-deep slice's row scale, slices in order: the TPU kernel's
//      pair-by-pair sum (:470-476, :490-493), with no atomics. The f32
//      attention output and its int8 copy go through device memory (the
//      TPU kernel keeps the accumulator in VMEM).
//
// What differs from the TPU kernels: they pair two dh = 64 heads into a
// 128-lane block and zero the other head's q lanes (K1, K3), because the
// TPU's lanes are 128 wide; here a head is a warp's mma.sync tile of any
// width the kernel is built for (dh = 32, 64 or 128; the int8 variants, on
// the paired path only, dh = 64), so no pairing and no masked dots. Their
// query blocks of 256 rows are 64 here: the rows of a block share one K/V
// tile stream through shared memory.

#include "common.cuh"

namespace nwt {

// ---------------------------------------------------------------------------
// attention: one (batch row, head) per blockIdx.(z, y), 64 query rows per
// block, head width DH. Strides in elements: a head's row t of batch row b
// starts at b * sb + h * sh + t * st (flat (B, T, d): sb = T d, sh = dh,
// st = d; per head (B, H, T, dh): sb = H T dh, sh = T dh, st = dh).
// ---------------------------------------------------------------------------

constexpr int AQ = 64;      // query rows per block (4 warps x 16)
constexpr int AK = 64;      // keys per tile
constexpr int VLD = AK + 8; // padded Vt row (36 words): no bank conflicts
constexpr int KLD8 = 64 + 16;  // padded int8 row (20 words): no conflicts

enum : int { I8_SCORES = 1, I8_PV = 2, FUSE_O = 4 };   // entry points' flags

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* o;         // bf16, or f32 for the fused o projection
  long long sb, sh, st;
  int n_real;
  float q_scale;   // q enters the scores as bf16(f32(q) * q_scale); with
                   // int8 scores the softmax scale of sq * (sk * scale)
  // int8 variants (flat layout, dh = 64): q quantized per (row, head) with
  // scales qs[(b T + t) H + h]; k and v quantized per (b, h) from the
  // absmax bits kamax[b H + h], vamax[b H + h]
  const int8_t* qq;
  const float* qs;
  const int8_t* kq;
  const int8_t* vq;
  const unsigned* kamax;
  const unsigned* vamax;
  int T, H;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 of q, scaled in f32 and rounded back to bf16
__device__ __forceinline__ uint32_t load_q2(const bf16* p, float scale) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  return pack_bf16(__fmul_rn(__low2float(v), scale),
                   __fmul_rn(__high2float(v), scale));
}

// four non-negative int8 values (0..127), the lowest first
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) |
         ((uint32_t)d << 24);
}

// a head's int8 scale from its absmax bits: max(absmax, 1e-6) / 127
__device__ __forceinline__ float head_scale(unsigned bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(bits), 1e-6f), 127.0f);
}

// Position of key j (0..63 of a tile) in the int8 PV operand's k order:
// inside each 32-key step, slot 4 t + i of the A fragment (thread t of a
// quad) holds the probability the scores' accumulator gives that thread:
// keys 2 t, 2 t + 1 of 8-key groups 0 and 1 (slots 0..15), of groups 2
// and 3 (slots 16..31).
__device__ __forceinline__ int key_slot(int j) {
  const int w = j & 31, half = w >> 4, grp = (w >> 3) & 1, r = w & 7;
  return (j & ~31) + half * 16 + (r >> 1) * 4 + grp * 2 + (r & 1);
}

// S (16 x 64 keys) of this warp's query rows against the key tile Ks
// ([key][DH + 8] row-major), keys >= n_real set to -1e30.
template <int DH>
__device__ __forceinline__ void scores_tile(const bf16* Ks,
                                            const uint32_t (&qa)[DH / 16][4],
                                            int key0, int n_real,
                                            float (&s)[8][4]) {
  constexpr int LD = DH + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LD + kk * 16 + t * 2);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * LD + kk * 16 + 8 + t * 2);
      mma_bf16(s[j], qa[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + j * 8 + t * 2 + (e & 1) >= n_real) s[j][e] = -1e30f;
  }
}

// The same with int8 q (dh = 64) against the int8 key tile Ks8 ([key][KLD8]):
// s = f32(int32 dot) * f, f = sq * (sk * scale) of the row (f0: row g,
// f1: row g + 8).
__device__ __forceinline__ void scores_tile_s8(const int8_t* Ks8,
                                               const uint32_t (&qa)[2][4],
                                               int key0, int n_real, float f0,
                                               float f1, float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int8_t* kr = Ks8 + (j * 8 + g) * KLD8 + kk * 32 + t * 4;
      mma_s8(c, qa[kk], *reinterpret_cast<const uint32_t*>(kr),
             *reinterpret_cast<const uint32_t*>(kr + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fmul_rn(__int2float_rn(c[e]), e < 2 ? f0 : f1);
      if (key0 + j * 8 + t * 2 + (e & 1) >= n_real) s[j][e] = -1e30f;
    }
  }
}

template <int DH, bool I8S, bool I8PV, typename OutT>
__global__ void __launch_bounds__(128) attn_kernel(AttnArgs p) {
  static_assert(!(I8S || I8PV) || DH == 64, "int8 variants: heads of 64");
  constexpr int LD = DH + 8;          // padded Ks row: no bank conflicts
  constexpr int CHUNKS = AK * DH / 8; // 16-byte chunks of one bf16 K or V tile
  constexpr int KS_BYTES = I8S ? AK * KLD8 : AK * LD * 2;
  constexpr int VS_BYTES = I8PV ? DH * KLD8 : DH * VLD * 2;
  __shared__ __align__(16) unsigned char ks_raw[KS_BYTES];
  __shared__ __align__(16) unsigned char vs_raw[VS_BYTES];
  bf16 (*Ks)[LD] = reinterpret_cast<bf16 (*)[LD]>(ks_raw);
  bf16 (*Vt)[VLD] = reinterpret_cast<bf16 (*)[VLD]>(vs_raw);    // [dh][key]
  int8_t (*Ks8)[KLD8] = reinterpret_cast<int8_t (*)[KLD8]>(ks_raw);
  int8_t (*Vt8)[KLD8] = reinterpret_cast<int8_t (*)[KLD8]>(vs_raw);  // [dh][slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = blockIdx.z * p.sb + blockIdx.y * p.sh;
  const int r0 = blockIdx.x * AQ + warp * 16 + g, r1 = r0 + 8;
  const int bh = blockIdx.z * p.H + blockIdx.y;

  uint32_t qa[DH / 16][4];           // bf16 q fragments
  uint32_t qa8[2][4];                // int8 q fragments (I8S)
  float f0 = 0.f, f1 = 0.f;          // per-row score factors (I8S)
  if constexpr (I8S) {
    const int8_t* Q = p.qq + base;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int8_t* q0 = Q + r0 * p.st + kk * 32 + t * 4;
      const int8_t* q1 = Q + r1 * p.st + kk * 32 + t * 4;
      qa8[kk][0] = *reinterpret_cast<const uint32_t*>(q0);
      qa8[kk][1] = *reinterpret_cast<const uint32_t*>(q1);
      qa8[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 16);
      qa8[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + 16);
    }
    const float ks = __fmul_rn(head_scale(p.kamax[bh]), p.q_scale);
    const size_t row0 = ((size_t)blockIdx.z * p.T + r0) * p.H + blockIdx.y;
    f0 = __fmul_rn(p.qs[row0], ks);
    f1 = __fmul_rn(p.qs[row0 + (size_t)8 * p.H], ks);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* q0 = p.q + base + r0 * p.st + kk * 16 + t * 2;
      const bf16* q1 = p.q + base + r1 * p.st + kk * 16 + t * 2;
      qa[kk][0] = load_q2(q0, p.q_scale);
      qa[kk][1] = load_q2(q1, p.q_scale);
      qa[kk][2] = load_q2(q0 + 8, p.q_scale);
      qa[kk][3] = load_q2(q1 + 8, p.q_scale);
    }
  }

  const int n_real = p.n_real;
  const int n_tiles = (n_real + AK - 1) / AK;

  auto load_k = [&](int kt) {
    if constexpr (I8S) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {              // 256 chunks of 16 B
        const int c = threadIdx.x + i * 128;
        const int kr = c >> 2, dc = (c & 3) * 16;
        *reinterpret_cast<int4*>(&Ks8[kr][dc]) =
            *reinterpret_cast<const int4*>(p.kq + base + (kt * AK + kr) * p.st + dc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CHUNKS / 128; ++i) {
        const int c = threadIdx.x + i * 128;
        const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
        *reinterpret_cast<int4*>(&Ks[kr][dc]) = *reinterpret_cast<const int4*>(
            p.k + base + (kt * AK + kr) * p.st + dc);
      }
    }
  };
  auto scores = [&](int kt, float (&s)[8][4]) {
    if constexpr (I8S)
      scores_tile_s8(&Ks8[0][0], qa8, kt * AK, n_real, f0, f1, s);
    else
      scores_tile<DH>(&Ks[0][0], qa, kt * AK, n_real, s);
  };

  // pass 1: row max
  float m0 = -3.0e38f, m1 = -3.0e38f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    load_k(kt);
    __syncthreads();
    float s[8][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
  }

  // pass 2: p = exp(s - max); bf16: sum p, o += bf16(p) @ v;
  // int8: pq = rint(p * 127), sum pq, o += pq @ vq
  float l0 = 0.f, l1 = 0.f;
  int lq0 = 0, lq1 = 0;
  float o[DH / 8][4];
  int oi[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[j][e] = 0.f;
      oi[j][e] = 0;
    }
  for (int kt = 0; kt < n_tiles; ++kt) {
    load_k(kt);
    if constexpr (I8PV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {              // 256 chunks of 16 B
        const int c = threadIdx.x + i * 128;
        const int kr = c >> 2, dc = (c & 3) * 16;
        int4 vv = *reinterpret_cast<const int4*>(
            p.vq + base + (kt * AK + kr) * p.st + dc);
        const int8_t* pv = reinterpret_cast<const int8_t*>(&vv);
        const int slot = key_slot(kr);
#pragma unroll
        for (int e = 0; e < 16; ++e) Vt8[dc + e][slot] = pv[e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < CHUNKS / 128; ++i) {
        const int c = threadIdx.x + i * 128;
        const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
        int4 vv = *reinterpret_cast<const int4*>(
            p.v + base + (kt * AK + kr) * p.st + dc);
        const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[dc + e][kr] = pv[e];
      }
    }
    __syncthreads();
    float s[8][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(__fsub_rn(s[j][0], m0));
      s[j][1] = expf(__fsub_rn(s[j][1], m0));
      s[j][2] = expf(__fsub_rn(s[j][2], m1));
      s[j][3] = expf(__fsub_rn(s[j][3], m1));
    }
    if constexpr (I8PV) {
      int pq[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pq[j][e] = (int)rintf(__fmul_rn(s[j][e], 127.0f));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lq0 += pq[j][0] + pq[j][1];
        lq1 += pq[j][2] + pq[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {         // 32 keys per step
        const int j = kk * 4;
        uint32_t pa[4];
        pa[0] = pack_s8(pq[j][0], pq[j][1], pq[j + 1][0], pq[j + 1][1]);
        pa[1] = pack_s8(pq[j][2], pq[j][3], pq[j + 1][2], pq[j + 1][3]);
        pa[2] = pack_s8(pq[j + 2][0], pq[j + 2][1], pq[j + 3][0], pq[j + 3][1]);
        pa[3] = pack_s8(pq[j + 2][2], pq[j + 2][3], pq[j + 3][2], pq[j + 3][3]);
#pragma unroll
        for (int jd = 0; jd < DH / 8; ++jd) {
          const int8_t* vr = &Vt8[jd * 8 + g][kk * 32 + t * 4];
          mma_s8(oi[jd], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 16));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {         // 16 keys per step
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int jd = 0; jd < DH / 8; ++jd) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(
              &Vt[jd * 8 + g][kk * 16 + t * 2]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(
              &Vt[jd * 8 + g][kk * 16 + 8 + t * 2]);
          mma_bf16(o[jd], pa, b0, b1);
        }
      }
    }
    __syncthreads();
  }
  float sv = 1.f;
  if constexpr (I8PV) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      lq0 += __shfl_xor_sync(0xffffffffu, lq0, off);
      lq1 += __shfl_xor_sync(0xffffffffu, lq1, off);
    }
    // sum pq <= 127 T < 2^24: exact in f32, as the reference's f32 sum
    l0 = fmaxf((float)lq0, 1.0f);
    l1 = fmaxf((float)lq1, 1.0f);
    sv = head_scale(p.vamax[bh]);
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] = __int2float_rn(oi[jd][e]);
  } else {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }

  OutT* O = static_cast<OutT*>(p.o) + base;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    const int c = jd * 8 + t * 2;
    float v00 = __fdiv_rn(o[jd][0], l0), v01 = __fdiv_rn(o[jd][1], l0);
    float v10 = __fdiv_rn(o[jd][2], l1), v11 = __fdiv_rn(o[jd][3], l1);
    if constexpr (I8PV) {
      v00 = __fmul_rn(v00, sv);
      v01 = __fmul_rn(v01, sv);
      v10 = __fmul_rn(v10, sv);
      v11 = __fmul_rn(v11, sv);
    }
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(O + r0 * p.st + c) = make_float2(v00, v01);
      *reinterpret_cast<float2*>(O + r1 * p.st + c) = make_float2(v10, v11);
    } else {
      *reinterpret_cast<uint32_t*>(O + r0 * p.st + c) = pack_bf16(v00, v01);
      *reinterpret_cast<uint32_t*>(O + r1 * p.st + c) = pack_bf16(v10, v11);
    }
  }
}

// grid (T / 64, H, B); the head widths the kernel is built for
inline cudaError_t launch_attn(const AttnArgs& a, int dh, int T, int H, int B,
                               cudaStream_t st) {
  const dim3 grid(T / AQ, H, B);
  switch (dh) {
    case 32: attn_kernel<32, false, false, bf16><<<grid, 128, 0, st>>>(a); break;
    case 64: attn_kernel<64, false, false, bf16><<<grid, 128, 0, st>>>(a); break;
    case 128: attn_kernel<128, false, false, bf16><<<grid, 128, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the flat path's variants at dh = 64: int8 scores and PV (flags), output
// in f32 for the fused o projection
template <typename OutT>
inline cudaError_t launch_attn_flat(const AttnArgs& a, int flags, int T,
                                    int H, int B, cudaStream_t st) {
  const dim3 grid(T / AQ, H, B);
  switch (flags & (I8_SCORES | I8_PV)) {
    case 0: attn_kernel<64, false, false, OutT><<<grid, 128, 0, st>>>(a); break;
    case I8_SCORES: attn_kernel<64, true, false, OutT><<<grid, 128, 0, st>>>(a); break;
    case I8_PV: attn_kernel<64, false, true, OutT><<<grid, 128, 0, st>>>(a); break;
    default: attn_kernel<64, true, true, OutT><<<grid, 128, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 variants' preparation
// ---------------------------------------------------------------------------

// q (M = B T rows, H heads of 64) -> qq = clip(rint(q / sq)), sq = max(absmax
// of the row's head, 1e-6) / 127 at qs[row H + h]. One warp per (row, head).
template <typename TQ>
__global__ void __launch_bounds__(256)
quant_q_kernel(const TQ* __restrict__ q, int8_t* __restrict__ qq,
               float* __restrict__ qs, long long n_heads, int H) {
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= n_heads) return;
  const int lane = threadIdx.x & 31;
  const long long off = w * 64 + lane * 2;   // (row, head) w is 64 contiguous
  const float a = to_f32(q[off]), b = to_f32(q[off + 1]);
  const float s = __fdiv_rn(fmaxf(warp_max(fmaxf(fabsf(a), fabsf(b))), 1e-6f),
                            127.0f);
  qq[off] = quant_s8(a, s);
  qq[off + 1] = quant_s8(b, s);
  if (lane == 0) qs[w] = s;
}

// per (batch row, head) absmax of z (k: blockIdx.z 0, v: 1; a null tensor
// is skipped) over rows < n_real, as float bits by atomicMax; grid
// (ceil(n_real / 32), B, 2), 256 threads over the d columns
__global__ void __launch_bounds__(256)
head_absmax_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   unsigned* __restrict__ amax, int T, int d, int n_real) {
  const bf16* z = blockIdx.z ? v : k;
  if (!z) return;
  const int H = d / 64, b = blockIdx.y;
  const int r_lo = blockIdx.x * 32, r_hi = min(r_lo + 32, n_real);
  unsigned* out = amax + ((size_t)blockIdx.z * gridDim.y + b) * H;
  for (int c = threadIdx.x; c < d; c += 256) {   // a warp: 32 columns, 1 head
    float m = 0.f;
    for (int r = r_lo; r < r_hi; ++r)
      m = fmaxf(m, fabsf(__bfloat162float(z[((size_t)b * T + r) * d + c])));
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) atomicMax(out + c / 64, __float_as_uint(m));
  }
}

// kq / vq = clip(rint(z * (1 / s))), s the head's scale; 8 values a thread;
// grid (ceil(B T d / 2048), 2): y 0 = k, 1 = v (null skipped)
__global__ void __launch_bounds__(256)
quant_kv_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                const unsigned* __restrict__ amax, int B, int T, int d) {
  const bf16* z = blockIdx.y ? v : k;
  int8_t* zq = blockIdx.y ? vq : kq;
  if (!z) return;
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 8;
  if (i >= (size_t)B * T * d) return;
  const int H = d / 64;
  const int b = (int)(i / ((size_t)T * d)), h = (int)(i % d) / 64;
  const float inv = __fdiv_rn(
      1.0f, head_scale(amax[((size_t)blockIdx.y * B + b) * H + h]));
  int4 raw = *reinterpret_cast<const int4*>(z + i);
  const bf16* zv = reinterpret_cast<const bf16*>(&raw);
  uint32_t w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = rintf(__fmul_rn(__bfloat162float(zv[4 * e + j]), inv));
      r[j] = (int)fminf(fmaxf(x, -127.0f), 127.0f);
    }
    w[e] = (uint32_t)(uint8_t)r[0] | ((uint32_t)(uint8_t)r[1] << 8) |
           ((uint32_t)(uint8_t)r[2] << 16) | ((uint32_t)(uint8_t)r[3] << 24);
  }
  *reinterpret_cast<uint2*>(zq + i) = make_uint2(w[0], w[1]);
}

// q (B, T, d) in TQ (K1: f32 unscaled; K3: bf16), k, v (B, T, d) bf16;
// d = 64 H. Writes what the flags ask for: qq, qs (int8 scores), kq (int8
// scores), vq (int8 PV); amax: (2, B, H) u32 scratch.
template <typename TQ>
inline cudaError_t int8_prep(const TQ* q, const bf16* k, const bf16* v,
                             int flags, int8_t* qq, float* qs, int8_t* kq,
                             int8_t* vq, unsigned* amax, int B, int T, int d,
                             int n_real, cudaStream_t st) {
  const int H = d / 64;
  const bool s8 = flags & I8_SCORES, pv = flags & I8_PV;
  cudaError_t e = cudaMemsetAsync(amax, 0, (size_t)2 * B * H * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  if (s8) {
    const long long n = (long long)B * T * H;
    quant_q_kernel<TQ><<<(unsigned)((n + 7) / 8), 256, 0, st>>>(q, qq, qs, n, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const bf16* kk = s8 ? k : nullptr;
  const bf16* vv = pv ? v : nullptr;
  head_absmax_kernel<<<dim3((n_real + 31) / 32, B, 2), 256, 0, st>>>(
      kk, vv, amax, T, d, n_real);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n8 = (size_t)B * T * d / 8;
  quant_kv_kernel<<<dim3((unsigned)((n8 + 255) / 256), 2), 256, 0, st>>>(
      kk, vv, kq, vq, amax, B, T, d);
  return cudaGetLastError();
}

// K1, every variant. x (B, T, d) bf16 with T % 64 == 0, d % 128 == 0,
// d == 64 * n_head; weights (d, d) int8 row-major (d_in, d_out) with (d,)
// f32 column scales; ln_g, ln_b, bq, bv, bo (d,) f32. Workspace: xq (B*T, d)
// int8, sx (B*T,) f32, q (B, T, d) bf16 (f32 with I8_SCORES), k, v (B, T, d)
// bf16; with FUSE_O a32 (B*T, d) f32, aq (B*T, d) int8, sa (B*T, d / 128)
// f32; with the int8 flags qq, qs, kq, vq, amax as int8_prep says. Writes
// out (B, T, d) bf16: the attention, or with FUSE_O x + attention @ wo + bo.
inline cudaError_t encoder_attention_fused_qkv(
    const void* x, const void* ln_g, const void* ln_b,
    const void* wq, const void* sq, const void* bq,
    const void* wk, const void* sk,
    const void* wv, const void* sv, const void* bv,
    const void* wo, const void* so, const void* bo,
    void* out, void* xq, void* sx, void* q, void* k, void* v,
    void* a32, void* aq, void* sa,
    void* qq, void* qs, void* kq, void* vq, void* amax,
    int B, int T, int d, int n_real, float sm_scale, int flags,
    cudaStream_t st) {
  const int M = B * T, H = d / 64;
  const bool s8 = flags & I8_SCORES, fuse_o = flags & FUSE_O;
  cudaError_t e = launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return e;

  e = launch_qkv_gemm<bf16>(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q, k, v,
                            sm_scale, M, d, st,
                            s8 ? static_cast<float*>(q) : nullptr);
  if (e != cudaSuccess) return e;
  if (flags & (I8_SCORES | I8_PV)) {
    e = int8_prep<float>(static_cast<const float*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), flags,
                         static_cast<int8_t*>(qq), static_cast<float*>(qs),
                         static_cast<int8_t*>(kq), static_cast<int8_t*>(vq),
                         static_cast<unsigned*>(amax), B, T, d, n_real, st);
    if (e != cudaSuccess) return e;
  }

  const unsigned* am = static_cast<const unsigned*>(amax);
  AttnArgs at{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), fuse_o ? a32 : out,
              (long long)T * d, 64, d, n_real,
              s8 ? sm_scale : 1.0f,       // q is scaled already otherwise
              static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
              static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
              am, am + (size_t)B * H, T, H};
  if (!fuse_o) return launch_attn_flat<bf16>(at, flags, T, H, B, st);
  e = launch_attn_flat<float>(at, flags, T, H, B, st);
  if (e != cudaSuccess) return e;

  // o projection: per-(row, head pair) quantization of the f32 attention
  // output (rows of 128), then x + bo + the pair slices' products in order
  e = launch_ln_quant<float, false>(static_cast<const float*>(a32), nullptr,
                                    nullptr, static_cast<int8_t*>(aq),
                                    static_cast<float*>(sa), M * (d / 128),
                                    128, st);
  if (e != cudaSuccess) return e;
  FC2Args<bf16> f;
  f.aq = static_cast<const int8_t*>(aq);
  f.amax = nullptr;
  f.sa = static_cast<const float*>(sa);
  f.w2 = static_cast<const int8_t*>(wo);
  f.s2 = static_cast<const float*>(so);
  f.b2 = static_cast<const float*>(bo);
  f.x = static_cast<const bf16*>(x);
  f.out = static_cast<bf16*>(out);
  f.M = M;
  f.d = d;
  f.F = d;
  f.block_f = 128;
  return launch_fc2_gemm(f, st);
}

}  // namespace nwt

using namespace nwt;

#define NWT_K1_ARGS                                                        \
  const void *x, const void *ln_g, const void *ln_b, const void *wq,      \
      const void *sq, const void *bq, const void *wk, const void *sk,     \
      const void *wv, const void *sv, const void *bv, const void *wo,     \
      const void *so, const void *bo, void *out, void *xq, void *sx,      \
      void *q, void *k, void *v, void *a32, void *aq, void *sa, void *qq, \
      void *qs, void *kq, void *vq, void *amax
#define NWT_K1_PASS                                                       \
  x, ln_g, ln_b, wq, sq, bq, wk, sk, wv, sv, bv, wo, so, bo, out, xq, sx, \
      q, k, v, a32, aq, sa, qq, qs, kq, vq, amax

// K1: see encoder_attention_fused_qkv above; flags: 1 int8 scores, 2 int8
// PV, 4 the o projection and residual fused (wo, so, bo, a32, aq, sa).
extern "C" int nwt_encoder_attention_fused_qkv(NWT_K1_ARGS, int B, int T,
                                               int d, int n_real,
                                               float sm_scale, int flags,
                                               void* stream) {
  return (int)encoder_attention_fused_qkv(
      NWT_K1_PASS, B, T, d, n_real, sm_scale, flags,
      reinterpret_cast<cudaStream_t>(stream));
}

// K3: q, k, v, out (B, T, d) bf16 in the flat layout, head h on columns
// [h dh, (h + 1) dh), d = H dh; T % 64 == 0, 0 < n_real <= T,
// dh in {32, 64, 128}.
extern "C" int nwt_encoder_attention_btd(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int T, int H, int dh, int n_real,
                                         float sm_scale, void* stream) {
  const long long d = (long long)H * dh;
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<bf16*>(out),
             T * d, dh, d, n_real, sm_scale};
  return (int)launch_attn(a, dh, T, H, B,
                          reinterpret_cast<cudaStream_t>(stream));
}

// K3's int8 variants (flags 1: int8 scores, 2: int8 PV; dh = 64): q, k, v,
// out (B, T, d) bf16, d = 64 H; workspace qq, qs, kq, vq, amax as int8_prep
// says.
extern "C" int nwt_encoder_attention_btd_int8(
    const void* q, const void* k, const void* v, void* out, void* qq,
    void* qs, void* kq, void* vq, void* amax, int B, int T, int H,
    int n_real, float sm_scale, int flags, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int d = 64 * H;
  cudaError_t e = int8_prep<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), flags, static_cast<int8_t*>(qq),
      static_cast<float*>(qs), static_cast<int8_t*>(kq),
      static_cast<int8_t*>(vq), static_cast<unsigned*>(amax), B, T, d,
      n_real, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned* am = static_cast<const unsigned*>(amax);
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), out, (long long)T * d, 64, d,
             n_real, sm_scale, static_cast<const int8_t*>(qq),
             static_cast<const float*>(qs), static_cast<const int8_t*>(kq),
             static_cast<const int8_t*>(vq), am, am + (size_t)B * H, T, H};
  return (int)launch_attn_flat<bf16>(a, flags, T, H, B, st);
}

// K9: q, k, v, out (B, H, T, dh) bf16; T % 64 == 0, 0 < n_real <= T,
// dh in {32, 64, 128}.
extern "C" int nwt_encoder_attention_bhtd(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int T, int dh, int n_real,
                                          float sm_scale, void* stream) {
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), static_cast<bf16*>(out),
             (long long)H * T * dh, (long long)T * dh, dh, n_real, sm_scale};
  return (int)launch_attn(a, dh, T, H, B,
                          reinterpret_cast<cudaStream_t>(stream));
}
