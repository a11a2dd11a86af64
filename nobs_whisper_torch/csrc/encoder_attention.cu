// Encoder self-attention: non-causal softmax attention per head, keys >=
// n_real masked, output in bf16. Three entry points share one attention
// kernel (attn_kernel, templated on the head width):
//
//   K1 nwt_encoder_attention_fused_qkv: LN1 -> per-row int8 quant -> int8
//      q/k/v projections -> attention, flat (B, T, d) layout. Replaces
//      nobs_whisper_tpu/ops/encoder_attention.py::encoder_attention_fused_qkv
//      (pallas_call at :565, kernel _attn_kernel_btd_fused :370 with
//      _make_scores :203 and _make_pv :292).
//   K3 nwt_encoder_attention_btd: attention on projected bf16 q/k/v in the
//      flat (B, T, d) layout. Replaces encoder_attention_btd (pallas_call at
//      :185, kernel _attn_kernel_btd :105), the float bf16 encoder's default.
//   K9 nwt_encoder_attention_bhtd: the same on per-head (B, H, T, dh)
//      tensors. Replaces encoder_attention (pallas_call at :93, kernel
//      _attn_kernel :35), taken where heads do not pair into 128 lanes.
//
// Bounds on an H100 at large-v3-turbo (T = 1536 padded, n_real = 1500,
// d = 1280, H = 20, dh = 64), per window and layer: QK^T and PV are
// 11.8 GFLOP bf16 over the real keys, about 12 us at the published bf16
// tensor-core peak; K3 and K9 move 4 x 3.9 MB of q/k/v/out, about 4.7 us, so
// they are compute-bound. K1 adds 15.1 G int8 operations in the
// projections (about 20 us in all; its bytes about 3.8 us).
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
//      bf16(q * dh^-0.5), bf16(k), bf16(v) — exactly the operands the TPU
//      kernel feeds its bf16 dots. The outputs make one round trip through
//      device memory
//      (3 x B x T x d bf16), which the TPU kernel keeps in VMEM.
//   3. attn_kernel: one block per (64 query rows, head, batch row), one warp
//      per 16 query rows, bf16 mma.sync with f32 accumulation. Strides say
//      where a head's rows lie, so one kernel reads the flat layout (K1, K3)
//      and the per-head one (K9). The q fragments are scaled while they are
//      loaded: bf16(f32(q) * scale), the TPU kernels' rounding (K1 passes
//      1.0, its q being scaled already, which leaves it unchanged). K and V
//      of one head at T = 1536 (2 x 196 KB at dh = 64) do not fit in shared
//      memory, and an online softmax would round bf16(p) against a running
//      max instead of the final one. So two passes over 64-key tiles: the
//      first finds the row max, the second computes p = exp(s - max)
//      exactly as the TPU kernels do, sums it in f32 and accumulates
//      bf16(p) @ v; the output is o / sum. Tiles wholly past n_real are
//      skipped (their p is exactly 0); padded query rows see real keys only,
//      so their output is finite.
//
// What differs from the TPU kernels: they pair two dh = 64 heads into a
// 128-lane block and zero the other head's q lanes (K1, K3), because the
// TPU's lanes are 128 wide; here a head is a warp's mma.sync tile of any
// width the kernel is built for (dh = 32, 64 or 128), so no pairing and no
// masked dots. Their query blocks of 256 rows are 64 here: the rows of a
// block share one K/V tile stream through shared memory.

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

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  long long sb, sh, st;
  int n_real;
  float q_scale;   // q enters the scores as bf16(f32(q) * q_scale)
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

template <int DH>
__global__ void __launch_bounds__(128) attn_kernel(AttnArgs p) {
  constexpr int LD = DH + 8;          // padded Ks row: no bank conflicts
  constexpr int CHUNKS = AK * DH / 8; // 16-byte chunks of one K or V tile
  __shared__ __align__(16) bf16 Ks[AK][LD];
  __shared__ __align__(16) bf16 Vt[DH][VLD];   // [dh][key]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = blockIdx.z * p.sb + blockIdx.y * p.sh;
  const int r0 = blockIdx.x * AQ + warp * 16 + g, r1 = r0 + 8;
  const bf16* K = p.k + base;
  const bf16* V = p.v + base;

  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* q0 = p.q + base + r0 * p.st + kk * 16 + t * 2;
    const bf16* q1 = p.q + base + r1 * p.st + kk * 16 + t * 2;
    qa[kk][0] = load_q2(q0, p.q_scale);
    qa[kk][1] = load_q2(q1, p.q_scale);
    qa[kk][2] = load_q2(q0 + 8, p.q_scale);
    qa[kk][3] = load_q2(q1 + 8, p.q_scale);
  }

  const int n_real = p.n_real;
  const int n_tiles = (n_real + AK - 1) / AK;

  // pass 1: row max
  float m0 = -3.0e38f, m1 = -3.0e38f;
  for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < CHUNKS / 128; ++i) {
      const int c = threadIdx.x + i * 128;
      const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
      *reinterpret_cast<int4*>(&Ks[kr][dc]) = *reinterpret_cast<const int4*>(
          K + (kt * AK + kr) * p.st + dc);
    }
    __syncthreads();
    float s[8][4];
    scores_tile<DH>(&Ks[0][0], qa, kt * AK, n_real, s);
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

  // pass 2: p = exp(s - max), sum p, o += bf16(p) @ v
  float l0 = 0.f, l1 = 0.f;
  float o[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < CHUNKS / 128; ++i) {
      const int c = threadIdx.x + i * 128;
      const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
      const long long off = (kt * AK + kr) * p.st + dc;
      *reinterpret_cast<int4*>(&Ks[kr][dc]) =
          *reinterpret_cast<const int4*>(K + off);
      int4 vv = *reinterpret_cast<const int4*>(V + off);
      const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[dc + e][kr] = pv[e];
    }
    __syncthreads();
    float s[8][4];
    scores_tile<DH>(&Ks[0][0], qa, kt * AK, n_real, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(__fsub_rn(s[j][0], m0));
      s[j][1] = expf(__fsub_rn(s[j][1], m0));
      s[j][2] = expf(__fsub_rn(s[j][2], m1));
      s[j][3] = expf(__fsub_rn(s[j][3], m1));
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
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  bf16* O = p.o + base;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    const int c = jd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(O + r0 * p.st + c) =
        pack_bf16(__fdiv_rn(o[jd][0], l0), __fdiv_rn(o[jd][1], l0));
    *reinterpret_cast<uint32_t*>(O + r1 * p.st + c) =
        pack_bf16(__fdiv_rn(o[jd][2], l1), __fdiv_rn(o[jd][3], l1));
  }
}

// grid (T / 64, H, B); the head widths the kernel is built for
inline cudaError_t launch_attn(const AttnArgs& a, int dh, int T, int H, int B,
                               cudaStream_t st) {
  const dim3 grid(T / AQ, H, B);
  switch (dh) {
    case 32: attn_kernel<32><<<grid, 128, 0, st>>>(a); break;
    case 64: attn_kernel<64><<<grid, 128, 0, st>>>(a); break;
    case 128: attn_kernel<128><<<grid, 128, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace nwt

using namespace nwt;

// x (B, T, d) bf16 with T % 64 == 0, d % 128 == 0, d == 64 * n_head;
// weights (d, d) int8 row-major (d_in, d_out) with (d,) f32 column scales;
// ln_g, ln_b, bq, bv (d,) f32. Workspace: xq (B*T, d) int8, sx (B*T,) f32,
// q, k, v (B, T, d) bf16. Writes out (B, T, d) bf16.
extern "C" int nwt_encoder_attention_fused_qkv(
    const void* x, const void* ln_g, const void* ln_b,
    const void* wq, const void* sq, const void* bq,
    const void* wk, const void* sk,
    const void* wv, const void* sv, const void* bv,
    void* out, void* xq, void* sx, void* q, void* k, void* v,
    int B, int T, int d, int n_real, float sm_scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * T;
  cudaError_t e = launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;

  e = launch_qkv_gemm<bf16>(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q, k, v,
                            sm_scale, M, d, st);
  if (e != cudaSuccess) return (int)e;

  AttnArgs at{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), static_cast<bf16*>(out),
              (long long)T * d, 64, d, n_real, 1.0f};
  return (int)launch_attn(at, 64, T, d / 64, B, st);
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
