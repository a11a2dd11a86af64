// Shared device code for the encoder kernels (sm_90a, plain C interface).
//
// Building blocks used by encoder_attention.cu (K1), fused_mlp.cu (K2, K8),
// fused_qkv.cu (K10, K11), fused_layer.cu (K12) and the decode kernels:
//
//   * ln_quant_kernel: LayerNorm in f32 (eps 1e-5) of bf16 or f32 rows and
//     dynamic per-row int8 quantization, s = max(absmax, 1e-6) / 127,
//     q = clip(rint(h / s)). This is the Pallas kernels' numerics
//     (encoder_attention.py:416-427, fused_mlp.py:231-239,
//     fused_qkv.py:31-41), not dense_int8_dynamic's 1e-8 floor. With LN =
//     false it quantizes the rows as they are (K11's attention input,
//     fused_qkv.py:107-110).
//   * dequant, chunk_scale: the int8 GEMMs' epilogue arithmetic, which the
//     int8 wgmma kernels (proj_wgmma.cuh, fused_mlp.cu) share; mma_bf16,
//     K6's tensor-core tile.
// The int8 GEMMs themselves run on wgmma (gemm_s8_wgmma.cuh); the port's
// first, mma.sync ones are frozen in tests/goldens/common_mma_sync.cuh as
// the bits those give.
//
// Arithmetic in the epilogues uses the _rn intrinsics so that nvcc does not
// contract a multiply and an add into one FMA: the plain PyTorch versions
// round after every operation, as the reference does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace nwt {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// once per device: a kernel's attributes (cudaFuncSetAttribute acts on the
// kernel in the current device's context only, so each card needs its own
// call) and the card's SM count, from any host thread
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

inline int current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// one bit a device; a device past MAX_DEVICES redoes the work every call
struct DeviceFlags {
  std::atomic<unsigned long long> bits{0};
  bool done(int dev) const {
    return dev >= 0 && dev < MAX_DEVICES &&
           ((bits.load(std::memory_order_acquire) >> dev) & 1ull);
  }
  void mark(int dev) {
    if (dev >= 0 && dev < MAX_DEVICES)
      bits.fetch_or(1ull << dev, std::memory_order_release);
  }
};

// ---------------------------------------------------------------------------
// LayerNorm + per-row int8 quantization (ln_quant_kernel below)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quant_s8(float v, float s) {
  float r = rintf(__fdiv_rn(v, s));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (int8_t)(int)r;
}

__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// two consecutive values of T as f32, and two f32 rounded to T
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// tanh gelu with f32 internals, op by op in the reference's order:
// (0.5 a) (1 + tanh(c (a + ((0.044715 a) a) a))), c = sqrt(2 / pi); tanhf,
// never a fast approximation (fused_mlp.py:126-128, conv_stem.py:48-50)
__device__ __forceinline__ float gelu_tanh(float a) {
  const float a3 = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, a), a), a);
  const float th = tanhf(__fmul_rn(0.7978845608028654f, __fadd_rn(a, a3)));
  return __fmul_rn(__fmul_rn(0.5f, a), __fadd_rn(1.0f, th));
}

// q = clip(rint(v / s)) as quant_s8 gives it, from r = RN(1 / s): t =
// RN(v r) lies within 2.3e-5 of RN(v / s) where |v / s| <= 127 (two
// roundings of 2^-24 each on a quotient below 128, and RN(v / s)'s own
// half ulp), so where t is further than 2^-14 from a half-integer both
// round to the same integer; nearer, the division decides
__device__ __forceinline__ int8_t quant_s8_r(float v, float s, float r) {
  const float t = __fmul_rn(v, r);
  const float n = rintf(t);
  float q = fabsf(__fsub_rn(t, n)) < 0.49993896484375f ? n
                                                      : rintf(__fdiv_rn(v, s));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return (int8_t)(int)q;
}

// 16 bytes of T (8 bf16 or 4 f32) from device memory into f32 in shared
// memory
__device__ __forceinline__ void stage16(float* h, const bf16* x) {
  const int4 u = __ldg(reinterpret_cast<const int4*>(x));
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  float2 f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat1622float2(p[i]);
  float4* h4 = reinterpret_cast<float4*>(h);
  h4[0] = make_float4(f[0].x, f[0].y, f[1].x, f[1].y);
  h4[1] = make_float4(f[2].x, f[2].y, f[3].x, f[3].y);
}
__device__ __forceinline__ void stage16(float* h, const float* x) {
  *reinterpret_cast<float4*>(h) = __ldg(reinterpret_cast<const float4*>(x));
}

__device__ __forceinline__ float amax4(float m, float4 v) {
  return fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                        fmaxf(fabsf(v.z), fabsf(v.w))));
}

// LN in f32 (eps 1e-5) of bf16 or f32 rows (T) and the per-row int8
// quantization s = max(absmax, 1e-6) / 127, q = clip(rint(h / s)); with
// LN = false the rows are quantized as they are (K11's and K1-o's input).
// One warp a row, the row staged in shared memory as f32 by 16-byte loads.
// The LN's two sums keep the order of the port's first version, and with
// it its bits: lane l adds columns l, l + 32, ... in turn, then the warp's
// butterfly. Everything else is elementwise or a max, so it runs in
// 16-byte order (lane l on columns 4 l .. 4 l + 3, then 128 further on):
// the LN, the absmax, and the quantization (quant_s8_r), stored four int8
// at a time. d % 8 == 0, x 16-byte aligned.
constexpr int LNQ_WARPS = 4;

template <typename T, bool LN = true>
__global__ void __launch_bounds__(LNQ_WARPS * 32)
ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ b, int8_t* __restrict__ xq,
                float* __restrict__ sx, int M, int d) {
  extern __shared__ float4 lnq_smem4[];
  constexpr int VEC = 16 / sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LNQ_WARPS + warp;
  if (row >= M) return;
  float* h = reinterpret_cast<float*>(lnq_smem4) + (size_t)warp * d;
  float4* h4 = reinterpret_cast<float4*>(h);
  const T* xr = x + (size_t)row * d;
  float amax = 0.f;
#pragma unroll 4
  for (int c = lane; c < d / VEC; c += 32) {
    stage16(h + c * VEC, xr + c * VEC);
    if (!LN) {
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j)
        amax = amax4(amax, h4[c * VEC / 4 + j]);
    }
  }
  __syncwarp();
  if (LN) {
    float s = 0.f;
#pragma unroll 8
    for (int c = lane; c < d; c += 32) s += h[c];
    const float mean = __fdiv_rn(warp_sum(s), (float)d);
    float s2 = 0.f;
#pragma unroll 8
    for (int c = lane; c < d; c += 32) {
      const float dv = __fsub_rn(h[c], mean);
      s2 = __fadd_rn(s2, __fmul_rn(dv, dv));
    }
    const float var = __fdiv_rn(warp_sum(s2), (float)d);
    const float rs = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-5f)));
    __syncwarp();   // every lane's sums read h before it is overwritten
    // ((h - mean) rs) g + b, rounded op by op
    auto ln = [&](float e, float gv, float bv) {
      return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(e, mean), rs), gv), bv);
    };
#pragma unroll 2
    for (int c = lane; c < d / 4; c += 32) {
      float4 v = h4[c];
      const float4 gg = __ldg(reinterpret_cast<const float4*>(g) + c);
      const float4 bb = __ldg(reinterpret_cast<const float4*>(b) + c);
      v = make_float4(ln(v.x, gg.x, bb.x), ln(v.y, gg.y, bb.y),
                      ln(v.z, gg.z, bb.z), ln(v.w, gg.w, bb.w));
      h4[c] = v;
      amax = amax4(amax, v);
    }
  }
  amax = warp_max(amax);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-6f), 127.0f);
  const float r = __frcp_rn(scale);
  char4* qr = reinterpret_cast<char4*>(xq + (size_t)row * d);
#pragma unroll 2
  for (int c = lane; c < d / 4; c += 32) {   // the lane's own h4[c]
    const float4 v = h4[c];
    qr[c] = make_char4(quant_s8_r(v.x, scale, r), quant_s8_r(v.y, scale, r),
                       quant_s8_r(v.z, scale, r), quant_s8_r(v.w, scale, r));
  }
  if (lane == 0) sx[row] = scale;
}

template <typename T, bool LN = true>
inline cudaError_t launch_ln_quant(const T* x, const float* g,
                                   const float* b, int8_t* xq, float* sx,
                                   int M, int d, cudaStream_t st) {
  if (d % 8) return cudaErrorInvalidValue;
  const size_t smem = (size_t)LNQ_WARPS * d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_quant_kernel<T, LN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_quant_kernel<T, LN><<<(M + LNQ_WARPS - 1) / LNQ_WARPS, LNQ_WARPS * 32,
                           smem, st>>>(x, g, b, xq, sx, M, d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core and epilogue pieces
// ---------------------------------------------------------------------------

// bf16 x bf16 -> f32 tensor-core tile (K6)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc_int32 -> f32 x row scale x column scale, in that order.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

// the requant scale of a (row, chunk), max(amax, 1e-6) / 127, from the
// chunk absmax's float bits (K2's fc1 writes them)
__device__ __forceinline__ float chunk_scale(const unsigned* amax, int row,
                                             int n_chunks, int chunk) {
  const float m = __uint_as_float(amax[(size_t)row * n_chunks + chunk]);
  return __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
}

}  // namespace nwt
