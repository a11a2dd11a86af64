// K1: LN1 -> per-row int8 quant -> int8 q/k/v projections -> non-causal
// softmax attention per head, keys >= n_real masked. Output is the pre-o
// attention (B, T, d) in bf16.
//
// Replaces the TPU kernel nobs_whisper_tpu/ops/encoder_attention.py::
// encoder_attention_fused_qkv (pallas_call at :565, kernel
// _attn_kernel_btd_fused :370 with _make_scores :203 and _make_pv :292).
//
// Bound on an H100 at large-v3-turbo (T = 1536, d = 1280, H = 20, dh = 64),
// per window and layer: 15.1 G int8 operations in the projections and
// 12.1 GFLOP bf16 in QK^T and PV, about 20 us at the published tensor-core
// peaks; the bytes take about 3.8 us. The kernel is compute-bound.
//
// Design, three launches:
//   1. ln_quant_kernel (common.cuh). The TPU kernel computes LN + quant
//      once per batch row into scratch that its later head-pair grid steps
//      reuse (encoder_attention.py:416-433). GPU blocks run in parallel and
//      in no order, so this is a separate pass writing int8 rows + scales.
//   2. qkv_gemm_kernel: the three projections as one int8 mma.sync GEMM
//      launch (grid.z picks q, k or v). The epilogue dequantizes
//      (acc * s_row * s_col + bias) and writes bf16(q * dh^-0.5), bf16(k),
//      bf16(v) — exactly the operands the TPU kernel feeds its bf16 dots.
//   3. attn_kernel: one block per (64 query rows, head, batch row), one warp
//      per 16 query rows, bf16 mma.sync with f32 accumulation. K and V of one
//      head at T = 1536 (2 x 196 KB) do not fit in shared memory, and an
//      online softmax would round bf16(p) against a running max instead of
//      the final one. So two passes over 64-key tiles: the first finds the
//      row max, the second computes p = exp(s - max) exactly as the TPU
//      kernel does, sums it in f32 and accumulates bf16(p) @ v; the output
//      is o / sum. Tiles wholly past n_real are skipped (their p is exactly
//      0); padded query rows see real keys only, so their output is finite.
//   The projections' outputs make one round trip through device memory
//   (3 x B x T x d bf16), which the TPU kernel keeps in VMEM.

#include "common.cuh"

namespace nwt {

// ---------------------------------------------------------------------------
// q/k/v projections
// ---------------------------------------------------------------------------

struct QKVArgs {
  const int8_t* xq;
  const float* sx;
  const int8_t* w[3];
  const float* s[3];
  const float* bias[3];   // k has none (nullptr)
  bf16* out[3];
  float q_scale;
  int M, d;
};

__global__ void __launch_bounds__(GTHREADS)
qkv_gemm_kernel(QKVArgs p) {
  __shared__ __align__(16) GemmSmem sm;
  const int z = blockIdx.z;
  const int n0 = blockIdx.x * GBN, m0 = blockIdx.y * GBM;
  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < p.d; k0 += GBK) {
    load_a_s8(sm, p.xq, p.d, m0, k0, p.M);
    load_b_s8(sm, p.w[z], p.d, k0, n0);
    __syncthreads();
    mma_slab(sm, acc);
    __syncthreads();
  }

  const float* s_col = p.s[z];
  const float* bias = p.bias[z];
  bf16* out = p.out[z];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), c = acc_col(n0, nt, e);
        if (r >= p.M) continue;
        float v = dequant(acc[mt][nt][e], p.sx[r], s_col[c]);
        if (bias) v = __fadd_rn(v, bias[c]);
        if (z == 0) v = __fmul_rn(v, p.q_scale);
        out[(size_t)r * p.d + c] = __float2bfloat16_rn(v);
      }
}

// ---------------------------------------------------------------------------
// attention, dh = 64
// ---------------------------------------------------------------------------

constexpr int AQ = 64;      // query rows per block (4 warps x 16)
constexpr int AK = 64;      // keys per tile
constexpr int ADH = 64;     // head dim
constexpr int ALD = ADH + 8;   // padded shared row (36 words): no conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (16 x 64 keys) of this warp's query rows against the key tile Ks
// ([key][ALD] row-major), keys >= n_real set to -1e30.
__device__ __forceinline__ void scores_tile(const bf16* Ks,
                                            const uint32_t (&qa)[4][4],
                                            int key0, int n_real,
                                            float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t b0 =
          *reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * ALD + kk * 16 + t * 2);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(Ks + (j * 8 + g) * ALD + kk * 16 + 8 + t * 2);
      mma_bf16(s[j], qa[kk], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + j * 8 + t * 2 + (e & 1) >= n_real) s[j][e] = -1e30f;
  }
}

__global__ void __launch_bounds__(128)
attn_kernel(const bf16* __restrict__ Q, const bf16* __restrict__ K,
            const bf16* __restrict__ V, bf16* __restrict__ O, int T, int d,
            int n_real) {
  __shared__ __align__(16) bf16 Ks[AK][ALD];
  __shared__ __align__(16) bf16 Vt[ADH][ALD];   // [dh][key]
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)b * T * d + (size_t)h * ADH;
  const int r0 = blockIdx.x * AQ + warp * 16 + g, r1 = r0 + 8;

  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* q0 = Q + base + (size_t)r0 * d + kk * 16 + t * 2;
    const bf16* q1 = Q + base + (size_t)r1 * d + kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(q0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(q1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + 8);
  }

  const int n_tiles = (n_real + AK - 1) / AK;

  // pass 1: row max
  float m0 = -3.0e38f, m1 = -3.0e38f;
  for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * 128;        // 512 chunks of 8 bf16
      const int kr = c >> 3, dc = (c & 7) * 8;
      *reinterpret_cast<int4*>(&Ks[kr][dc]) = *reinterpret_cast<const int4*>(
          K + base + (size_t)(kt * AK + kr) * d + dc);
    }
    __syncthreads();
    float s[8][4];
    scores_tile(&Ks[0][0], qa, kt * AK, n_real, s);
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
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * 128;
      const int kr = c >> 3, dc = (c & 7) * 8;
      const size_t off = base + (size_t)(kt * AK + kr) * d + dc;
      *reinterpret_cast<int4*>(&Ks[kr][dc]) =
          *reinterpret_cast<const int4*>(K + off);
      int4 vv = *reinterpret_cast<const int4*>(V + off);
      const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[dc + e][kr] = pv[e];
    }
    __syncthreads();
    float s[8][4];
    scores_tile(&Ks[0][0], qa, kt * AK, n_real, s);
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
      for (int jd = 0; jd < 8; ++jd) {
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

#pragma unroll
  for (int jd = 0; jd < 8; ++jd) {
    const int c = jd * 8 + t * 2;
    *reinterpret_cast<uint32_t*>(O + base + (size_t)r0 * d + c) =
        pack_bf16(__fdiv_rn(o[jd][0], l0), __fdiv_rn(o[jd][1], l0));
    *reinterpret_cast<uint32_t*>(O + base + (size_t)r1 * d + c) =
        pack_bf16(__fdiv_rn(o[jd][2], l1), __fdiv_rn(o[jd][3], l1));
  }
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

  QKVArgs a;
  a.xq = static_cast<const int8_t*>(xq);
  a.sx = static_cast<const float*>(sx);
  a.w[0] = static_cast<const int8_t*>(wq);
  a.w[1] = static_cast<const int8_t*>(wk);
  a.w[2] = static_cast<const int8_t*>(wv);
  a.s[0] = static_cast<const float*>(sq);
  a.s[1] = static_cast<const float*>(sk);
  a.s[2] = static_cast<const float*>(sv);
  a.bias[0] = static_cast<const float*>(bq);
  a.bias[1] = nullptr;
  a.bias[2] = static_cast<const float*>(bv);
  a.out[0] = static_cast<bf16*>(q);
  a.out[1] = static_cast<bf16*>(k);
  a.out[2] = static_cast<bf16*>(v);
  a.q_scale = sm_scale;
  a.M = M;
  a.d = d;
  dim3 ggrid(d / GBN, (M + GBM - 1) / GBM, 3);
  qkv_gemm_kernel<<<ggrid, GTHREADS, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  dim3 agrid(T / AQ, d / ADH, B);
  attn_kernel<<<agrid, 128, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), T, d, n_real);
  return (int)cudaGetLastError();
}
