// K14 nwt_log10_mel: (B, n_rows x 160) f32 PCM rows -> (B, n_frames,
// n_mels) f32 un-normalized log10 mel: the windowed DFT, power, the mel
// filterbank and log10 of 30 s windows in one kernel.
//
// Replaces nobs_whisper_tpu/ops/mel_pallas.py::log10_mel_pallas
// (pallas_call at :116, kernel _mel_kernel :55). Numerics are the TPU
// kernel's function in f32 at Precision.HIGHEST:
//   re[f][k] = sum_t x[160 f + t] cos_t[t][k],  im likewise with sin_t,
//   power = re re + im im (each product rounded, then the sum),
//   out[f][m] = log10(max(sum_k power[f][k] melf[k][m], 1e-10)),
// where x is the reflect-padded signal (the wrapper pads it and cuts it
// into rows of 160, as the TPU wrapper does) and cos_t/sin_t are the
// window-folded bases, read from the wrapper's _padded_tables (tap t lies in
// block t / 160, row t % 160). Every product runs on FFMA in true f32: an f32
// mma on the tensor cores is TF32 and would lose the reference's precision
// ahead of a log10. The sums run in another order than the TPU's (or the
// plain version's) matmuls, so bins far below a sample's max differ in their
// low bits; the clamp at max - 8 outside the kernel hides them.
//
// What bounds it on an H100: operations. A 30 s window is 3000 frames x 400
// taps x 201 bins x 2 (cos, sin) multiply-adds, 0.965 GFLOP, plus 3000 x 201
// x n_mels x 2 for the filterbank (0.154 GFLOP at 128 mels), against 1.92 MB
// of PCM in and 1.54 MB of mel out: about 320 operations a byte, far above
// the f32 FFMA peak's 67 TFLOP/s over 3.35 TB/s (20 a byte).
//
// Design: one block per (window, tile of 64 frames), 256 threads.
//   * The tile's signal span (63 x 160 + 400 samples) is staged once in
//     shared memory; frame f's taps are the span read at 160 f, so the
//     frames are never materialized (the TPU kernel's three row-shifted
//     matmuls are the same sum cut at 160 and 320 taps).
//   * The bases stream through shared memory in tiles of 16 taps x 224 bins
//     (cos and sin; bins 201-223 are zero columns of the tables), double
//     buffered with cp.async. Each thread holds re and im of 8 frames x 7
//     bins in registers (112 accumulators); a warp's lanes own 32
//     neighbouring bins of the same 8 frames, so each signal value is one
//     broadcast load and each basis value one conflict-free load per warp,
//     22 shared loads per 112 FFMA.
//   * The power tile (64 x 224) replaces the basis buffers in shared memory;
//     the filterbank product reads it there, with lanes on neighbouring mel
//     bins (filterbank rows from L2), and the log10 is applied on the way
//     out. Nothing but the PCM in and the mel out touches device memory.

#include "common.cuh"

namespace nwt {

constexpr int MEL_HOP = 160, MEL_TAPS = 400;
constexpr int MEL_BM = 64;                       // frames per block
constexpr int MEL_BK = 16;                       // taps per basis tile
constexpr int MEL_TN = 7;                        // bins per thread
constexpr int MEL_NB = 32 * MEL_TN;              // 224 bins computed
constexpr int MEL_NREAL = 201;                   // rfft bins
constexpr int MEL_TM = 8;                        // frames per thread
constexpr int MEL_THREADS = 256;
constexpr int MEL_PAD = 256;                     // table rows: lanes, bins
constexpr int MEL_SPAN = (MEL_BM - 1) * MEL_HOP + MEL_TAPS;   // 10480
constexpr int MEL_BROW = 2 * MEL_NB;             // cos | sin per tap: 448
constexpr int MEL_BTILE = MEL_BK * MEL_BROW;     // floats per basis tile
constexpr int MEL_MAX_MELS = 128;

static_assert(MEL_HOP % MEL_BK == 0, "a basis tile never straddles a block");
static_assert(MEL_TAPS % MEL_BK == 0, "whole basis tiles");
static_assert(MEL_BM == MEL_TM * (MEL_THREADS / 32), "one warp per 8 frames");
static_assert(MEL_BM * MEL_NB <= 2 * MEL_BTILE, "power fits the basis buffers");

constexpr size_t MEL_SMEM = sizeof(float) * (MEL_SPAN + 2 * MEL_BTILE);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// basis tile kt (taps 16 kt .. 16 kt + 15) -> dst[16][448]: cos bins 0-223,
// then sin bins 0-223, from the split (3, 256, 256) tables
__device__ __forceinline__ void load_basis_tile(float* dst, const float* cosp,
                                                const float* sinp, int kt) {
  constexpr int V_ROW = MEL_NB / 4;                    // float4 per half row
  for (int v = threadIdx.x; v < MEL_BK * 2 * V_ROW; v += MEL_THREADS) {
    const int kk = v / (2 * V_ROW), rem = v % (2 * V_ROW);
    const int half = rem / V_ROW, c4 = rem % V_ROW;
    const int t = kt * MEL_BK + kk;
    const size_t row = (size_t)(t / MEL_HOP) * MEL_PAD + t % MEL_HOP;
    const float* src = (half ? sinp : cosp) + row * MEL_PAD + 4 * c4;
    cp_async16(dst + kk * MEL_BROW + half * MEL_NB + 4 * c4, src);
  }
}

__global__ void __launch_bounds__(MEL_THREADS)
log10_mel_kernel(const float* __restrict__ rows, const float* __restrict__ cosp,
                 const float* __restrict__ sinp, const float* __restrict__ melf,
                 float* __restrict__ out, int n_frames, int n_mels) {
  extern __shared__ __align__(16) float mel_smem[];
  float* sig = mel_smem;                       // [MEL_SPAN]
  float* bas = mel_smem + MEL_SPAN;            // [2][MEL_BTILE], later power
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, f0 = blockIdx.x * MEL_BM;
  const size_t n_samp = (size_t)(n_frames + 8) * MEL_HOP;
  const float* x = rows + (size_t)b * n_samp + (size_t)f0 * MEL_HOP;
  const size_t left = n_samp - (size_t)f0 * MEL_HOP;   // samples from f0 on

  load_basis_tile(bas, cosp, sinp, 0);
  cp_async_commit();
  for (int v = tid; v < MEL_SPAN / 4; v += MEL_THREADS) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((size_t)4 * v + 4 <= left)
      q = *reinterpret_cast<const float4*>(x + 4 * v);
    *reinterpret_cast<float4*>(sig + 4 * v) = q;
  }

  float re[MEL_TM][MEL_TN], im[MEL_TM][MEL_TN];
#pragma unroll
  for (int i = 0; i < MEL_TM; ++i)
#pragma unroll
    for (int c = 0; c < MEL_TN; ++c) re[i][c] = im[i][c] = 0.f;

  const float* fs = sig + warp * MEL_TM * MEL_HOP;   // this warp's 8 frames
  constexpr int NT = MEL_TAPS / MEL_BK;
  for (int kt = 0; kt < NT; ++kt) {
    if (kt + 1 < NT) {
      load_basis_tile(bas + ((kt + 1) & 1) * MEL_BTILE, cosp, sinp, kt + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* bt = bas + (kt & 1) * MEL_BTILE;
#pragma unroll 4
    for (int kk = 0; kk < MEL_BK; ++kk) {
      const int t = kt * MEL_BK + kk;
      float a[MEL_TM];
#pragma unroll
      for (int i = 0; i < MEL_TM; ++i) a[i] = fs[i * MEL_HOP + t];
#pragma unroll
      for (int c = 0; c < MEL_TN; ++c) {
        const float bc = bt[kk * MEL_BROW + lane + 32 * c];
        const float bs = bt[kk * MEL_BROW + MEL_NB + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < MEL_TM; ++i) {
          re[i][c] = fmaf(a[i], bc, re[i][c]);
          im[i][c] = fmaf(a[i], bs, im[i][c]);
        }
      }
    }
    __syncthreads();
  }

  // power tile [64][224] in the basis buffers
  float* pw = bas;
#pragma unroll
  for (int i = 0; i < MEL_TM; ++i)
#pragma unroll
    for (int c = 0; c < MEL_TN; ++c)
      pw[(warp * MEL_TM + i) * MEL_NB + lane + 32 * c] = __fadd_rn(
          __fmul_rn(re[i][c], re[i][c]), __fmul_rn(im[i][c], im[i][c]));
  __syncthreads();

  // filterbank: lanes on mel bins lane + 32 j, the warp's 8 frames
  constexpr int MJ = MEL_MAX_MELS / 32;
  float acc[MEL_TM][MJ];
#pragma unroll
  for (int i = 0; i < MEL_TM; ++i)
#pragma unroll
    for (int j = 0; j < MJ; ++j) acc[i][j] = 0.f;
  const float* pf = pw + warp * MEL_TM * MEL_NB;
  for (int k = 0; k < MEL_NREAL; ++k) {
    float w[MJ];
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = lane + 32 * j;
      w[j] = m < n_mels ? __ldg(melf + (size_t)k * n_mels + m) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MEL_TM; ++i) {
      const float p = pf[i * MEL_NB + k];
#pragma unroll
      for (int j = 0; j < MJ; ++j) acc[i][j] = fmaf(p, w[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < MEL_TM; ++i) {
    const int f = f0 + warp * MEL_TM + i;
    if (f >= n_frames) break;
    float* o = out + ((size_t)b * n_frames + f) * n_mels;
#pragma unroll
    for (int j = 0; j < MJ; ++j) {
      const int m = lane + 32 * j;
      if (m < n_mels) o[m] = log10f(fmaxf(acc[i][j], 1e-10f));
    }
  }
}

}  // namespace nwt

using namespace nwt;

// rows: (B, (n_frames + 8) x 160) f32, the reflect-padded signal
// zero-extended; cosp, sinp: (3, 256, 256) f32 split bases; melf: (256,
// n_mels) f32; out: (B, n_frames, n_mels) f32. n_mels <= 128.
extern "C" int nwt_log10_mel(const void* rows, const void* cosp,
                             const void* sinp, const void* melf, void* out,
                             int B, int n_frames, int n_mels, void* stream) {
  if (B <= 0 || n_frames <= 0 || n_mels <= 0 || n_mels > MEL_MAX_MELS ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      log10_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MEL_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n_frames + MEL_BM - 1) / MEL_BM, B);
  log10_mel_kernel<<<grid, MEL_THREADS, MEL_SMEM,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(cosp),
      static_cast<const float*>(sinp), static_cast<const float*>(melf),
      static_cast<float*>(out), n_frames, n_mels);
  return (int)cudaGetLastError();
}
