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
//
// What bounds it on an H100: bytes. In a decode step M is the batch (<= 8
// in the serving configuration) and each weight byte meets M rows of x, far
// below the ~295 operations per byte at which the tensor cores, not the
// 3.35 TB/s of HBM, would be the limit. The int8 weight is the traffic: the
// logit projection (1280 x 51,866) is 66 MB, about 20 us at the memory
// rate, where the dequantize-then-matmul path reads the int8, writes bf16
// and reads the bf16 again (about 5 bytes a weight).
//
// Design:
//   * The weight is read once, as int8, and never exists in bf16 outside
//     shared memory. A block owns a 64-column tile of N and a 64-row tile
//     of M and walks K in 64-row slabs; each thread loads 4 bytes of a slab
//     row (16 threads a row), rounds them to bf16 with the column scales it
//     holds in registers, and writes them k-major to shared memory, where
//     ldmatrix.trans feeds mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   * Ragged N. N need not be a multiple of 16 (the logit projection's
//     51,866 is 2 mod 16), so a row of the (K, N) weight starts at any byte.
//     Each thread loads the aligned 32-bit word holding its first byte; the
//     next word comes from the neighbouring thread by shuffle (the row's
//     last thread loads it), and a funnel shift cuts out the thread's 4
//     bytes. Columns >= N get a zero scale, so whatever lies past the row
//     end multiplies by zero; no word is read that starts past the row end.
//   * Bytes in flight. The next slab's words are loaded into registers
//     while the tensor cores work on the current one. With M = 8 the grid
//     of N / 64 tiles is too small for weights of 1280 columns (20 tiles),
//     so K is split across blocks until the grid holds about eight blocks
//     a streaming multiprocessor; the blocks add their partial sums into the
//     zeroed f32 output with atomics (the order of those adds, and so the
//     last bit of a sum, can differ from run to run).
//   * M up to 256 (the prefill's B x P rows) runs 64-row tiles; the blocks
//     of one column tile are adjacent in the grid, so the weight tile they
//     share is read from L2 after the first.

#include <algorithm>

#include "common.cuh"

namespace nwt {

constexpr int QBM = 64, QBN = 64, QBK = 64, QTHREADS = 128;
constexpr int QLDS = 72;   // bf16 per shared row: 144 B, ldmatrix conflict-free

struct Q8Smem {
  bf16 x[QBM][QLDS];   // [m][k]
  bf16 w[QBK][QLDS];   // [k][n]
};

__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows of a 64-row weight slab each thread loads: (tid >> 4) + 8 i
constexpr int QROWS = QBK * 16 / QTHREADS;

template <typename T>
__global__ void __launch_bounds__(QTHREADS)
q8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s, float* __restrict__ out, int M,
                 int K, int N, int k_per_split) {
  __shared__ __align__(16) Q8Smem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * QBM, n0 = blockIdx.y * QBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int rows = min(QBM, M - m0);
  const int j = tid & 15, r0 = tid >> 4;

  // this thread's 4 columns: bf16-rounded scales, 0 past N
  float sc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + 4 * j + i;
    sc[i] = n < N ? __bfloat162float(__float2bfloat16_rn(s[n])) : 0.f;
  }
  // x rows past M stay zero for the whole block
  for (int e = tid; e < (QBM - rows) * QBK; e += QTHREADS)
    sm.x[rows + e / QBK][e % QBK] = __float2bfloat16_rn(0.f);

  uint32_t lo[QROWS], ex[QROWS];
  auto prefetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < QROWS; ++i) {
      const int k = k0 + r0 + 8 * i;
      lo[i] = 0u;
      ex[i] = 0u;
      if (k < kend) {
        const int8_t* row = w + (size_t)k * N;
        const uintptr_t p = reinterpret_cast<uintptr_t>(row + n0 + 4 * j);
        const uintptr_t end = reinterpret_cast<uintptr_t>(row + N);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(p & ~uintptr_t(3));
        if (reinterpret_cast<uintptr_t>(wp) < end) lo[i] = __ldg(wp);
        if (j == 15 && reinterpret_cast<uintptr_t>(wp + 1) < end)
          ex[i] = __ldg(wp + 1);
      }
    }
  };
  // byte offset of a slab row's first column within its aligned word: the
  // same for every row when N % 4 == 0, else it changes with k
  auto shift_of = [&](int k) {
    return (int)((reinterpret_cast<uintptr_t>(w) + (size_t)k * N + n0) & 3);
  };

  float acc[4][2][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  prefetch(kbeg);
  for (int k0 = kbeg; k0 < kend; k0 += QBK) {
    // dequantize this slab into shared memory: 4 bytes a thread and row
#pragma unroll
    for (int i = 0; i < QROWS; ++i) {
      const uint32_t nxt = __shfl_down_sync(0xffffffffu, lo[i], 1);
      const uint32_t hi = j == 15 ? ex[i] : nxt;
      const uint32_t v =
          __funnelshift_r(lo[i], hi, 8 * shift_of(k0 + r0 + 8 * i));
      float f[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[b] = __fmul_rn((float)(int8_t)(v >> (8 * b)), sc[b]);
      const __nv_bfloat162 w01 = __floats2bfloat162_rn(f[0], f[1]);
      const __nv_bfloat162 w23 = __floats2bfloat162_rn(f[2], f[3]);
      *reinterpret_cast<uint2*>(&sm.w[r0 + 8 * i][4 * j]) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&w01),
                     *reinterpret_cast<const uint32_t*>(&w23));
    }
    if (k0 + QBK < kend) prefetch(k0 + QBK);
    // this slab of x, rounded to bf16 (columns past kend are zero)
    for (int e = tid; e < rows * QBK; e += QTHREADS) {
      const int r = e / QBK, c = e % QBK;
      sm.x[r][c] = k0 + c < kend ? to_bf16(x[(size_t)(m0 + r) * K + k0 + c])
                                 : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QBK; kk += 16) {
      uint32_t bfr[4];
      ldsm_x4_trans(bfr, &sm.w[kk + (lane & 7) + ((lane >> 3) & 1) * 8]
                              [warp * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt * 16 >= rows) break;
        uint32_t afr[4];
        ldsm_x4(afr, &sm.x[mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                          [kk + (lane >> 4) * 8]);
        mma_bf16(acc[mt][0], afr, bfr[0], bfr[1]);
        mma_bf16(acc[mt][1], afr, bfr[2], bfr[3]);
      }
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (mt * 16 >= rows) break;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + warp * 16 + nt * 8 + 2 * t + (e & 1);
        if (r < M && n < N) atomicAdd(out + (size_t)r * N + n, acc[mt][nt][e]);
      }
  }
}

template <typename T>
inline cudaError_t launch_q8_matmul(const T* x, const int8_t* w,
                                    const float* s, float* out, int M, int K,
                                    int N, cudaStream_t st) {
  if (M <= 0 || K <= 0 || N <= 0) return cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int mb = (M + QBM - 1) / QBM, nb = (N + QBN - 1) / QBN;
  const int slabs = (K + QBK - 1) / QBK;
  // split K until the grid holds about eight blocks a multiprocessor
  const long long want = 8LL * sms;
  int splits = (int)((want + (long long)mb * nb - 1) / ((long long)mb * nb));
  splits = std::max(1, std::min(splits, slabs));
  const int per = (slabs + splits - 1) / splits;
  splits = (slabs + per - 1) / per;
  if (splits > 65535 || nb > 65535) return cudaErrorInvalidValue;
  const dim3 grid(mb, nb, splits);
  q8_matmul_kernel<T><<<grid, QTHREADS, 0, st>>>(x, w, s, out, M, K, N,
                                                 per * QBK);
  return cudaGetLastError();
}

}  // namespace nwt

using namespace nwt;

// x (M, K) bf16 or f32 row-major; w (K, N) int8 row-major (the reference's
// (d_in, d_out) layout, any byte alignment); s (N,) f32. out (M, N) f32 must
// be zeroed by the caller: split-K blocks add into it.
extern "C" int nwt_q8_matmul_bf16(const void* x, const void* w, const void* s,
                                  void* out, int M, int K, int N,
                                  void* stream) {
  return (int)launch_q8_matmul(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w),
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
