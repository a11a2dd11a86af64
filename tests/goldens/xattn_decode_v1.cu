// The port's first K4 and K5 (one 256-thread block per (batch row, head)),
// kept beside the tests as the bits reference for
// csrc/cross_attention_decode.cu's K4, which keeps this kernel, and as the
// baseline that scripts/torch_xattn_variants.py times K5 against
// (tests/test_torch_kernels_gpu.py builds this file on the card). It
// includes common_v1.cuh, the common.cuh it was built with.
//
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
// large-v3-turbo (H = 20, Dh = 64, Tp = 1536) and B = 8, K4 reads 62.9 MB of
// bf16 (about 19 us at 3.35 TB/s) and K5 33.5 MB of int8 and scales (about
// 10 us); the arithmetic is a few hundred MFLOP.
//
// Design: one block of 256 threads per (batch row, head). The scores row
// (Tp f32, 6 KB at Tp = 1536) stays in shared memory, so K and V are each
// read once, in three phases: (1) each thread owns 8 consecutive positions
// and walks the Dh rows of K with 16-byte (bf16) or 8-byte (int8) loads,
// several rows in flight; (2) block max, exp, block sum and the
// normalisation in place; (3) each thread owns 8 of the Dh columns and
// every 32nd position of V (neighbouring threads read neighbouring bytes of
// a row), and the per-thread partial sums are added in a fixed order.
// Phase 1 of K4 skips position chunks wholly past t_real, phase 3 the
// positions past it; both are zero-probability terms. The grid is B x H
// blocks: 160 at B = 8 (1.2 per multiprocessor), 20 at B = 1, so a small
// batch leaves most of the card idle; splitting Tp across blocks is a later
// change.

#include <algorithm>

#include "common_v1.cuh"

namespace nwt {

constexpr int XA_THREADS = 256;
constexpr int XA_RED = 2048;   // floats of the phase-3 partial sums

struct XAArgs {
  const bf16* q;        // (BH, Dh)
  const void* k;        // (BH, Dh, Tp) bf16 or int8
  const float* ks;      // (BH, Tp) or null
  const void* v;        // (BH, Tp, Dh) bf16 or int8
  const float* vs;      // (BH, Tp) or null
  float* out;           // (BH, Dh)
  int Tp, t_real;
  float scale;
};

// 8 consecutive elements as f32, from 16 (bf16) or 8 (int8) aligned bytes
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = (float)(int8_t)(u.x >> (8 * i));
    f[4 + i] = (float)(int8_t)(u.y >> (8 * i));
  }
}

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  __syncthreads();                      // red may hold a previous result
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < XA_THREADS / 32; ++i)
    r = is_max ? fmaxf(r, red[i]) : __fadd_rn(r, red[i]);
  return r;
}

template <int DH, typename KV>
__global__ void __launch_bounds__(XA_THREADS)
xattn_decode_kernel(XAArgs a) {
  constexpr bool Q8 = sizeof(KV) == 1;
  extern __shared__ float sc[];         // scores, then probabilities
  __shared__ float qs[DH];
  __shared__ float red[XA_THREADS / 32];
  const int tid = threadIdx.x, bh = blockIdx.x, Tp = a.Tp;
  const KV* k = static_cast<const KV*>(a.k) + (size_t)bh * DH * Tp;
  const KV* v = static_cast<const KV*>(a.v) + (size_t)bh * Tp * DH;
  const float* ks = Q8 ? a.ks + (size_t)bh * Tp : nullptr;
  const float* vs = Q8 ? a.vs + (size_t)bh * Tp : nullptr;
  // K4 needs the positions below t_real only (whole 8-position chunks)
  const int t_lim = Q8 ? Tp : min(Tp, (a.t_real + 7) & ~7);

  if (tid < DH) qs[tid] = __bfloat162float(a.q[(size_t)bh * DH + tid]);
  __syncthreads();

  // (1) scores: each thread 8 consecutive positions, all Dh rows of K
  float mx = __int_as_float(0xff800000u);   // -inf
  for (int c = tid; c < t_lim / 8; c += XA_THREADS) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float kf[8];
      load8(k + (size_t)d * Tp + 8 * c, kf);
      const float qd = qs[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = fmaf(qd, kf[i], acc[i]);  // exact products
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * c + i;
      float s;
      if (Q8) {
        const float st = ks[t];
        s = st > 0.f ? __fmul_rn(__fmul_rn(acc[i], st), a.scale) : -1e30f;
      } else {
        s = t < a.t_real ? __fmul_rn(acc[i], a.scale) : -1e30f;
      }
      sc[t] = s;
      mx = fmaxf(mx, s);
    }
  }
  mx = block_reduce(mx, red, true);

  // (2) p = exp(s - max), the sum, then p / sum (and, K5, bf16(p * vs))
  float sum = 0.f;
  for (int t = tid; t < t_lim; t += XA_THREADS) {
    const float p = expf(__fsub_rn(sc[t], mx));
    sc[t] = p;
    sum = __fadd_rn(sum, p);
  }
  sum = block_reduce(sum, red, false);
  for (int t = tid; t < t_lim; t += XA_THREADS) {
    float p = __fdiv_rn(sc[t], sum);
    if (Q8) p = __fmul_rn(p, vs[t]);
    sc[t] = __bfloat162float(__float2bfloat16_rn(p));
  }
  __syncthreads();

  // (3) out = p @ V: thread (tl, dg) owns columns 8 dg .. 8 dg + 7 and
  // positions tl, tl + TL, ...
  constexpr int DG = DH / 8, TL = XA_THREADS / DG;
  const int dg = tid % DG, tl = tid / DG;
  const int t_end = Q8 ? Tp : a.t_real;
  float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int t = tl; t < t_end; t += TL) {
    float vf[8];
    load8(v + (size_t)t * DH + 8 * dg, vf);
    const float p = sc[t];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = fmaf(p, vf[i], o[i]);
  }
  __syncthreads();                      // sc is reused for the partials
#pragma unroll
  for (int i = 0; i < 8; ++i) sc[tl * DH + 8 * dg + i] = o[i];
  __syncthreads();
  if (tid < DH) {
    float r = 0.f;
    for (int i = 0; i < TL; ++i) r = __fadd_rn(r, sc[i * DH + tid]);
    a.out[(size_t)bh * DH + tid] = r;
  }
}

template <typename KV>
inline cudaError_t launch_xattn(const XAArgs& a, int BH, int dh,
                                cudaStream_t st) {
  if (BH <= 0 || a.Tp <= 0 || a.Tp % 8) return cudaErrorInvalidValue;
  const size_t smem = (size_t)std::max(a.Tp, XA_RED) * sizeof(float);
  auto run = [&](auto kernel) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<BH, XA_THREADS, smem, st>>>(a);
    return cudaGetLastError();
  };
  switch (dh) {
    case 32: return run(xattn_decode_kernel<32, KV>);
    case 64: return run(xattn_decode_kernel<64, KV>);
    case 128: return run(xattn_decode_kernel<128, KV>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace nwt

using namespace nwt;

// K4. q (BH, Dh) bf16; kT (BH, Dh, Tp) and v (BH, Tp, Dh) bf16, Tp % 8 == 0,
// 0 < t_real <= Tp, dh in {32, 64, 128}. Writes out (BH, Dh) f32.
extern "C" int nwt_xattn_decode_bf16(const void* q, const void* kT,
                                     const void* v, void* out, int BH, int dh,
                                     int Tp, int t_real, float scale,
                                     void* stream) {
  if (t_real <= 0 || t_real > Tp) return (int)cudaErrorInvalidValue;
  XAArgs a{static_cast<const bf16*>(q), kT, nullptr, v, nullptr,
           static_cast<float*>(out), Tp, t_real, scale};
  return (int)launch_xattn<bf16>(a, BH, dh,
                                 reinterpret_cast<cudaStream_t>(stream));
}

// K5. q (BH, Dh) bf16; kq (BH, Dh, Tp) and vq (BH, Tp, Dh) int8 with ks, vs
// (BH, Tp) f32, Tp % 8 == 0, dh in {32, 64, 128}. Writes out (BH, Dh) f32.
extern "C" int nwt_xattn_decode_q8(const void* q, const void* kq,
                                   const void* ks, const void* vq,
                                   const void* vs, void* out, int BH, int dh,
                                   int Tp, float scale, void* stream) {
  XAArgs a{static_cast<const bf16*>(q), kq, static_cast<const float*>(ks), vq,
           static_cast<const float*>(vs), static_cast<float*>(out), Tp, Tp,
           scale};
  return (int)launch_xattn<int8_t>(a, BH, dh,
                                   reinterpret_cast<cudaStream_t>(stream));
}
