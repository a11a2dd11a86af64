// K14 nwt_log10_mel: (B, T) f32 PCM -> (B, n_frames, n_mels) f32
// un-normalized log10 mel: reflect pad, the Hann-windowed real FFT of each
// 400-tap frame, power, the mel filterbank and log10 of 30 s windows in one
// kernel.
//
// Replaces nobs_whisper_tpu/ops/mel_pallas.py::log10_mel_pallas
// (pallas_call at :116, kernel _mel_kernel :55). Its function, in f32:
//   X[f][k] = sum_t x[160 f + t] w[t] e^(-2 pi i t k / 400), k = 0..200,
//   power = re re + im im (each product rounded, then the sum),
//   out[f][m] = log10(max(sum_k power[f][k] melf[m][k], 1e-10)),
// where x is the signal reflect-padded by 200 samples at each edge (zeros
// past that) and w the periodic Hann window. The TPU kernel runs the DFT
// as dense f32 matmuls at Precision.HIGHEST against window-folded bases;
// here it is an FFT, every product on FFMA in true f32 (an f32 mma on the
// tensor cores is TF32 and would lose the reference's precision ahead of a
// log10). Its rounding differs from the dense sums' (an FFT's error grows
// as log N, a dense sum's as N), so bins far below a sample's max differ
// in their low bits; the clamp at max - 8 outside the kernel hides them.
// The max - 8 clamp and the normalization stay outside, as in the TPU
// kernel.
//
// What bounds it on an H100: bytes. A 30 s window is 1.92 MB of PCM in and
// 1.54 MB of mel out at 128 mels; the FFT is about 10 kFLOP a frame (30
// MFLOP a window), the filterbank's nonzeros about 0.8 kFLOP: some 9
// operations a byte, under the f32 FFMA peak's 20 (67 TFLOP/s over 3.35
// TB/s). The design keeps every intermediate on chip and the arithmetic
// near the FFT's count.
//
// Design: one block per (window, tile of MEL_FT = 16 frames), 256 threads.
//   * The tile's span of the padded signal (15 x 160 + 400 samples) is read
//     straight from the (B, T) PCM into shared memory: the reflect pad and
//     the zero tail are index arithmetic, so no padded copy exists.
//   * The 400-point real DFT as 16 x 25 (Cooley-Tukey, n = 25 n1 + n2, k =
//     k1 + 16 k2): stage 1, one thread per (frame, n2), takes the windowed
//     taps n2, 25 + n2, ..., 375 + n2, runs a real 16-point DFT (radix 4 x
//     4) for k1 = 0..8 (the rest are its conjugates), multiplies by the
//     twiddles W400^(n2 k1) and stores them in shared memory. Stage 2, one
//     thread per (frame, k1 = 0..8), runs the 25-point DFT over n2 (radix
//     5 x 5) in registers and writes the power of each bin it owns: k =
//     k1 + 16 k2 where k <= 200, else the mirror bin 400 - k (|X[400 - k]|
//     = |X[k]| for real input), each of the 201 bins once.
//   * Hann window, twiddles and radix constants are one table the host
//     computes in f64 and rounds to f32 (ops/mel_pallas.py::_fft_tables),
//     as the TPU wrapper rounds its bases.
//   * The filterbank: each mel band's nonzero weights are one contiguous
//     range of bins (a triangle); the host passes each band's range and
//     those weights band after band (394 at 128 mels, staged in shared
//     memory), and one thread per (frame, band) sums power[k] melf[m][k]
//     over the range in increasing k. The products dropped are products of
//     +0 weights by non-negative powers. log10 is applied on the way out,
//     the stores coalesced along the bands.
//   * 47 KB of shared memory (the span, later the power tile; the stage 1
//     outputs; the tables) and no spills: several blocks an SM. Inside the
//     signal the span is read with 16-byte loads all in flight at once.

#include "common.cuh"

namespace nwt {

constexpr int MEL_HOP = 160, MEL_TAPS = 400, MEL_PAD = 200;
constexpr int MEL_FT = 16;                              // frames per block
constexpr int MEL_THREADS = 256;
constexpr int MEL_NREAL = 201;                          // rfft bins
constexpr int MEL_SPAN = (MEL_FT - 1) * MEL_HOP + MEL_TAPS;   // 2800
constexpr int MEL_POW = MEL_FT * MEL_NREAL;                   // 3216
constexpr int MEL_MAX_MELS = 128;
// the table's layout (floats), as ops/mel_pallas.py::_fft_tables builds it
constexpr int TAB_HANN = 0;           // w[t], t = 0..399
constexpr int TAB_W400 = 400;         // W400^(n2 k1): [k1 0..8][n2 0..24] (re, im)
constexpr int TAB_W25 = 850;          // W25^(p2 q1): [p2 0..4][q1 0..4] (re, im)
constexpr int TAB_W16 = 900;          // W16^j, j = 0..9 (re, im)
constexpr int TAB_W5 = 920;           // cos 2pi/5, sin 2pi/5, cos 4pi/5, sin 4pi/5
constexpr int TAB_SMEM = 900;         // floats staged in shared memory
constexpr int TAB_SIZE = 924;
static_assert(TAB_W5 + 4 == TAB_SIZE && TAB_SMEM % 4 == 0, "table layout");
// the filterbank's nonzero weights, band after band (each bin feeds at
// most two triangular bands: at most 402)
constexpr int MEL_MAX_NNZ = 416;

struct __align__(8) cf {
  float re, im;
};
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cf cmul(cf a, cf w) {
  return {a.re * w.re - a.im * w.im, a.re * w.im + a.im * w.re};
}
// a - i b
__device__ __forceinline__ cf csub_i(cf a, cf b) { return {a.re + b.im, a.im - b.re}; }
// a + i b
__device__ __forceinline__ cf cadd_i(cf a, cf b) { return {a.re - b.im, a.im + b.re}; }

// 5-point DFT in place, X[q] = sum_p x[p] W5^(p q), W5 = e^(-2 pi i / 5);
// c1, s1, c2, s2 = cos, sin of 2 pi / 5 and 4 pi / 5
__device__ __forceinline__ void dft5(cf& x0, cf& x1, cf& x2, cf& x3, cf& x4,
                                     float c1, float s1, float c2, float s2) {
  const cf t1 = cadd(x1, x4), t2 = cadd(x2, x3);
  const cf t3 = csub(x1, x4), t4 = csub(x2, x3);
  const cf b1 = {x0.re + c1 * t1.re + c2 * t2.re, x0.im + c1 * t1.im + c2 * t2.im};
  const cf b2 = {x0.re + c2 * t1.re + c1 * t2.re, x0.im + c2 * t1.im + c1 * t2.im};
  const cf e1 = {s1 * t3.re + s2 * t4.re, s1 * t3.im + s2 * t4.im};
  const cf e2 = {s2 * t3.re - s1 * t4.re, s2 * t3.im - s1 * t4.im};
  x0 = cadd(x0, cadd(t1, t2));
  x1 = csub_i(b1, e1);
  x4 = cadd_i(b1, e1);
  x2 = csub_i(b2, e2);
  x3 = cadd_i(b2, e2);
}

__global__ void __launch_bounds__(MEL_THREADS)
log10_mel_kernel(const float* __restrict__ audio, const float* __restrict__ tab,
                 const int* __restrict__ bands, const float* __restrict__ wts,
                 float* __restrict__ out, int T, int n_frames, int n_mels) {
  __shared__ __align__(16) float sig[MEL_POW];   // the span; later the power
  __shared__ cf stage1[MEL_FT * 9 * 25];         // [frame][k1][n2]
  __shared__ __align__(16) float tb[TAB_SMEM];
  __shared__ __align__(16) float wb[MEL_MAX_NNZ];
  const int tid = threadIdx.x, b = blockIdx.y, f0 = blockIdx.x * MEL_FT;
  const float* x = audio + (size_t)b * T;

  for (int i = tid; i < (TAB_SMEM + MEL_MAX_NNZ) / 4; i += MEL_THREADS) {
    if (i < TAB_SMEM / 4)
      reinterpret_cast<float4*>(tb)[i] = __ldg(reinterpret_cast<const float4*>(tab) + i);
    else
      reinterpret_cast<float4*>(wb)[i - TAB_SMEM / 4] =
          __ldg(reinterpret_cast<const float4*>(wts) + i - TAB_SMEM / 4);
  }
  // padded index p = 160 f0 + i holds x[p - 200], reflected at both edges;
  // inside the signal, 16-byte loads all in flight at once
  const long long a0 = (long long)f0 * MEL_HOP - MEL_PAD;
  if (a0 >= 0 && a0 + MEL_SPAN <= T &&
      (reinterpret_cast<uintptr_t>(x + a0) & 15) == 0) {
    constexpr int N4 = MEL_SPAN / 4, R = (N4 + MEL_THREADS - 1) / MEL_THREADS;
    const float4* src = reinterpret_cast<const float4*>(x + a0);
    float4 r[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (tid + j * MEL_THREADS < N4) r[j] = __ldg(src + tid + j * MEL_THREADS);
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (tid + j * MEL_THREADS < N4)
        reinterpret_cast<float4*>(sig)[tid + j * MEL_THREADS] = r[j];
  } else {
    for (int i = tid; i < MEL_SPAN; i += MEL_THREADS) {
      const long long a = a0 + i;
      float v = 0.f;
      if (a < 0)
        v = x[-a];
      else if (a < T)
        v = x[a];
      else if (a < (long long)T + MEL_PAD)
        v = x[2 * (long long)T - 2 - a];
      sig[i] = v;
    }
  }
  __syncthreads();

  // stage 1: (frame, n2) -> 16-point real DFT of the windowed taps
  // 25 n1 + n2, k1 = 0..8, times W400^(n2 k1)
  {
    const cf* w16 = reinterpret_cast<const cf*>(tab + TAB_W16);
    const cf w1 = w16[1], w2 = w16[2], w3 = w16[3], w4 = w16[4], w6 = w16[6],
             w9 = w16[9];
    for (int it = tid; it < MEL_FT * 25; it += MEL_THREADS) {
      const int f = it / 25, n2 = it % 25;
      const float* fr = sig + f * MEL_HOP + n2;
      float xw[16];
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1)
        xw[n1] = fr[25 * n1] * tb[TAB_HANN + 25 * n1 + n2];
      // radix 4 over n1 = 4 m1 + m2: for each m2, the real 4-point DFT
      float s[4], u2[4];
      cf u1[4];
#pragma unroll
      for (int m2 = 0; m2 < 4; ++m2) {
        const float a = xw[m2], bb = xw[4 + m2], c = xw[8 + m2], d = xw[12 + m2];
        const float apc = a + c, bpd = bb + d;
        s[m2] = apc + bpd;
        u2[m2] = apc - bpd;
        u1[m2] = {a - c, d - bb};
      }
      cf y[9];
      // k1 = 0, 4, 8 from the real sums
      y[0] = {(s[0] + s[2]) + (s[1] + s[3]), 0.f};
      y[8] = {(s[0] + s[2]) - (s[1] + s[3]), 0.f};
      y[4] = {s[0] - s[2], s[3] - s[1]};
      // k1 = k1a + 4 k1b for k1a = 1, 2, 3: twiddle W16^(m2 k1a), then the
      // 4-point DFT over m2 for k1b = 0, 1
      auto comb = [&](cf v0, cf v1, cf v2, cf v3, int k1a) {
        const cf d02 = cadd(v0, v2), d13 = cadd(v1, v3);
        y[k1a] = cadd(d02, d13);
        y[k1a + 4] = csub_i(csub(v0, v2), csub(v1, v3));
      };
      const cf c1 = {u1[0].re, -u1[0].im}, c2 = {u1[1].re, -u1[1].im};
      const cf c3 = {u1[2].re, -u1[2].im}, c4 = {u1[3].re, -u1[3].im};
      comb(u1[0], cmul(u1[1], w1), cmul(u1[2], w2), cmul(u1[3], w3), 1);
      comb({u2[0], 0.f}, {u2[1] * w2.re, u2[1] * w2.im},
           {u2[2] * w4.re, u2[2] * w4.im}, {u2[3] * w6.re, u2[3] * w6.im}, 2);
      comb(c1, cmul(c2, w3), cmul(c3, w6), cmul(c4, w9), 3);
      cf* dst = stage1 + f * 225 + n2;
      dst[0] = y[0];
      const cf* tw = reinterpret_cast<const cf*>(tb + TAB_W400) + n2;
#pragma unroll
      for (int k1 = 1; k1 < 9; ++k1) dst[25 * k1] = cmul(y[k1], tw[25 * k1]);
    }
  }
  __syncthreads();

  // stage 2: (frame, k1) -> 25-point DFT over n2 = 5 p1 + p2 (k2 = q1 + 5
  // q2), then the power of bin k1 + 16 k2 or its mirror
  float* pw = sig;
  if (tid < MEL_FT * 9) {
    const int f = tid / 9, k1 = tid % 9;
    const float c1 = tab[TAB_W5], s1 = tab[TAB_W5 + 1];
    const float c2 = tab[TAB_W5 + 2], s2 = tab[TAB_W5 + 3];
    const cf* w25 = reinterpret_cast<const cf*>(tb + TAB_W25);
    cf z[25];
    const cf* src = stage1 + f * 225 + 25 * k1;
#pragma unroll
    for (int n = 0; n < 25; ++n) z[n] = src[n];
    // over p1 for each p2: z[5 p1 + p2] -> G[p2][q1] at z[5 q1 + p2]
#pragma unroll
    for (int p2 = 0; p2 < 5; ++p2) {
      dft5(z[p2], z[5 + p2], z[10 + p2], z[15 + p2], z[20 + p2], c1, s1, c2,
           s2);
#pragma unroll
      for (int q1 = 1; q1 < 5; ++q1)
        if (p2 > 0) z[5 * q1 + p2] = cmul(z[5 * q1 + p2], w25[5 * p2 + q1]);
    }
    // over p2 for each q1: X[q1 + 5 q2] at z[5 q1 + q2]
#pragma unroll
    for (int q1 = 0; q1 < 5; ++q1)
      dft5(z[5 * q1], z[5 * q1 + 1], z[5 * q1 + 2], z[5 * q1 + 3],
           z[5 * q1 + 4], c1, s1, c2, s2);
    float* prow = pw + f * MEL_NREAL;
#pragma unroll
    for (int q1 = 0; q1 < 5; ++q1)
#pragma unroll
      for (int q2 = 0; q2 < 5; ++q2) {
        const int k2 = q1 + 5 * q2, k = k1 + 16 * k2;
        const cf v = z[5 * q1 + q2];
        const float pv = __fadd_rn(__fmul_rn(v.re, v.re), __fmul_rn(v.im, v.im));
        if (k <= 200)
          prow[k] = pv;
        else if (k1 > 0 && k1 < 8)
          prow[400 - k] = pv;
      }
  }
  __syncthreads();

  // the filterbank over each band's bins, log10; a warp's lanes on
  // neighbouring bands of one frame, so the stores are coalesced
  const int warp = tid >> 5, lane = tid & 31;
  for (int f = warp; f < MEL_FT && f0 + f < n_frames;
       f += MEL_THREADS / 32) {
    const float* pr = pw + f * MEL_NREAL;
    float* orow = out + ((size_t)b * n_frames + f0 + f) * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int lo = __ldg(bands + 3 * m), hi = __ldg(bands + 3 * m + 1);
      const float* wr = wb + __ldg(bands + 3 * m + 2) - lo;
      float acc = 0.f;
      for (int k = lo; k <= hi; ++k) acc = fmaf(pr[k], wr[k], acc);
      orow[m] = log10f(fmaxf(acc, 1e-10f));
    }
  }
}

}  // namespace nwt

using namespace nwt;

// audio: (B, T) f32 PCM, T > 200; tab: the (924,) f32 FFT table; bands:
// (n_mels, 3) int32, each band's first and last nonzero bin (last < first
// for an empty band) and the offset of its weights in wts; wts: (416,) f32,
// the filterbank's nonzero weights band after band, zero-padded; out: (B,
// n_frames, n_mels) f32. n_mels <= 128.
extern "C" int nwt_log10_mel(const void* audio, const void* tab,
                             const void* bands, const void* wts, void* out,
                             int B, int T, int n_frames, int n_mels,
                             void* stream) {
  if (B <= 0 || T <= MEL_PAD || n_frames <= 0 || n_mels <= 0 ||
      n_mels > MEL_MAX_MELS || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_frames + MEL_FT - 1) / MEL_FT, B);
  log10_mel_kernel<<<grid, MEL_THREADS, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float*>(tab),
      static_cast<const int*>(bands), static_cast<const float*>(wts),
      static_cast<float*>(out), T, n_frames, n_mels);
  return (int)cudaGetLastError();
}
