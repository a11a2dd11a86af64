// K13 nwt_encoder_stem: the encoder's conv stem at bf16 under
// NWT_STEM_FUSED, conv1 (k3, s1) -> gelu -> conv2 (k3, s2) -> gelu -> + pos,
// rows >= t_real written as exact zeros up to t_out_pad.
//
// Replaces nobs_whisper_tpu/ops/conv_stem.py::encoder_stem_fused
// (pallas_call at :160, kernel _stem_kernel :68). Numerics are the TPU
// kernel's, at its rounding points (conv_stem.py:92-115):
//   A[r]   = rg(sum_j mel[r + j - 1] @ w1_j + b1),   r < n_frames
//   out[t] = bf16(rg(sum_j A[2t + j - 1] @ w2_j + b2) + pos[t]),  t < t_real
// with mel rows and weights in bf16, products exact and sums in f32, the
// convs' zero padding at rows -1 and n_frames, and rg(s) = bf16(gelu(f32(
// bf16(s)))): the sum rounded to bf16, then the tanh gelu with f32 internals
// (gelu_tanh in common.cuh, tanhf), then rounded to bf16. That is not the
// unfused bf16 stem's gelu, which rounds every operation to bf16; the pos
// add is a bf16 add, as in the unfused stem.
//
// Bound on an H100 at large-v3-turbo (B = 2 windows, C_in = 128 mel
// channels, 3000 frames, d = 1280): conv1 is 2 x 6000 x 384 x 1280 = 5.9
// GFLOP and conv2 2 x 3000 x 3840 x 1280 = 29.5 GFLOP in bf16, about 36 us
// at the published bf16 tensor-core peak, against about 26 MB of traffic
// (mel, weights, conv1's output written and read, out), about 8 us: the
// kernel is compute-bound.
//
// Design: one implicit-GEMM kernel, launched twice (conv1, then conv2).
// Output row r of a batch row reads input rows stride * r + j - 1 for the
// three taps j, so the GEMM's K axis is (tap, channel) and an A tile is
// three shifted row windows of the input, read straight from it (rows
// outside [0, n_in) read as zero: the convs' padding). bf16 mma.sync
// m16n8k16 with f32 accumulation, 128 x 128 block tiles of 8 warps (64 x 32
// each), 32-wide K slabs staged in shared memory. The epilogue applies the
// bias, rg, and for conv2 the pos add and the zero rows.
//   * conv1's output A (B x n_frames x d bf16, 15.4 MB at B = 2) makes one
//     round trip through device memory. The TPU kernel keeps it in VMEM,
//     one batch row at a time; keeping it on chip here is later work.
//   * The TPU kernel's even/odd half-rate mel streams and its row rolls are
//     layout devices of its 8-row sublanes; the GPU reads the shifted rows
//     directly and needs neither.
//   * The caller hands the mel rows as (B, n_frames, C) bf16 with C padded
//     to a multiple of 32 by zero channels, as the TPU wrapper transposes,
//     casts and lane-pads them outside its kernel (conv_stem.py:135-137),
//     and the weights as (d, 3 C) bf16, n-major, so that both operand tiles
//     load as contiguous 16-byte rows.

#include "common.cuh"

namespace nwt {

constexpr int SBM = 128, SBN = 128, SBK = 32;
constexpr int SLD = SBK + 8;   // bf16 per shared row: 80 B, conflict-free

struct StemSmem {
  bf16 a[SBM][SLD];   // [row][k]
  bf16 b[SBN][SLD];   // [n][k]
};

struct ConvArgs {
  const bf16* x;      // (B, n_in, C) input rows
  const bf16* wt;     // (N, 3 C): wt[n][j C + c] = w[j][c][n]
  const float* bias;  // (N,)
  const bf16* pos;    // (>= n_out, N) added after the gelu, or nullptr
  bf16* y;            // (B, rows_out, N)
  int n_in, C, N, stride, n_out, rows_out;
};

__global__ void __launch_bounds__(GTHREADS) conv_k3_kernel(ConvArgs p) {
  __shared__ __align__(16) StemSmem sm;
  const int n0 = blockIdx.x * SBN, m0 = blockIdx.y * SBM, b = blockIdx.z;
  const int K = 3 * p.C;
  const bf16* xb = p.x + (size_t)b * p.n_in * p.C;
  bf16* yb = p.y + (size_t)b * p.rows_out * p.N;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (m0 < p.n_out) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
    for (int k0 = 0; k0 < K; k0 += SBK) {
      const int tap = k0 / p.C, c0 = k0 % p.C;   // C % 32 == 0
#pragma unroll
      for (int i = 0; i < 2; ++i) {              // 512 chunks of 16 B each
        const int ch = threadIdx.x + i * GTHREADS;
        const int r = ch >> 2, kc = (ch & 3) * 8;
        const int row = m0 + r, src = row * p.stride + tap - 1;
        int4 v = make_int4(0, 0, 0, 0);
        if (row < p.n_out && src >= 0 && src < p.n_in)
          v = *reinterpret_cast<const int4*>(xb + (size_t)src * p.C + c0 + kc);
        *reinterpret_cast<int4*>(&sm.a[r][kc]) = v;
        *reinterpret_cast<int4*>(&sm.b[r][kc]) =
            *reinterpret_cast<const int4*>(p.wt + (size_t)(n0 + r) * K + k0 +
                                           kc);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < SBK; ks += 16) {
        uint32_t af[4][4], bfr[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int r = wm * 64 + mt * 16 + g;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(&sm.a[r][ks + 2 * t]);
          af[mt][1] =
              *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][ks + 2 * t]);
          af[mt][2] =
              *reinterpret_cast<const uint32_t*>(&sm.a[r][ks + 8 + 2 * t]);
          af[mt][3] =
              *reinterpret_cast<const uint32_t*>(&sm.a[r + 8][ks + 8 + 2 * t]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = wn * 32 + nt * 8 + g;
          bfr[nt][0] = *reinterpret_cast<const uint32_t*>(&sm.b[n][ks + 2 * t]);
          bfr[nt][1] =
              *reinterpret_cast<const uint32_t*>(&sm.b[n][ks + 8 + 2 * t]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
      }
      __syncthreads();
    }
  }

  // acc_row / acc_col: the m16n8 accumulator layout of this 2 x 4 warp grid
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(m0, mt, e), c = acc_col(n0, nt, e);
        if (r >= p.rows_out) continue;
        bf16 out = __float2bfloat16_rn(0.f);
        if (r < p.n_out) {
          const float s = __bfloat162float(
              __float2bfloat16_rn(__fadd_rn(acc[mt][nt][e], p.bias[c])));
          out = __float2bfloat16_rn(gelu_tanh(s));
          if (p.pos)
            out = __float2bfloat16_rn(__fadd_rn(
                __bfloat162float(out),
                __bfloat162float(p.pos[(size_t)r * p.N + c])));
        }
        yb[(size_t)r * p.N + c] = out;
      }
}

inline cudaError_t launch_conv(const ConvArgs& a, int B, cudaStream_t st) {
  if (a.C % SBK || a.N % SBN || a.rows_out < a.n_out) return cudaErrorInvalidValue;
  const dim3 grid(a.N / SBN, (a.rows_out + SBM - 1) / SBM, B);
  conv_k3_kernel<<<grid, GTHREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace nwt

using namespace nwt;

// mel (B, n_frames, C) bf16, C % 32 == 0 (zero channels past the real
// ones); w1t (d, 3 C) and w2t (d, 3 d) bf16 n-major; b1, b2 (d,) f32; pos
// (>= n_frames / 2, d) bf16; d % 128 == 0, n_frames even, t_out_pad >=
// n_frames / 2. Workspace: a (B, n_frames, d) bf16. Writes out (B,
// t_out_pad, d) bf16.
extern "C" int nwt_encoder_stem(const void* mel, const void* w1t,
                                const void* b1, const void* w2t,
                                const void* b2, const void* pos, void* a,
                                void* out, int B, int n_frames, int C, int d,
                                int t_out_pad, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ConvArgs c1{static_cast<const bf16*>(mel), static_cast<const bf16*>(w1t),
              static_cast<const float*>(b1), nullptr, static_cast<bf16*>(a),
              n_frames, C, d, 1, n_frames, n_frames};
  cudaError_t e = launch_conv(c1, B, st);
  if (e != cudaSuccess) return (int)e;
  ConvArgs c2{static_cast<const bf16*>(a), static_cast<const bf16*>(w2t),
              static_cast<const float*>(b2), static_cast<const bf16*>(pos),
              static_cast<bf16*>(out), n_frames, d, d, 2, n_frames / 2,
              t_out_pad};
  return (int)launch_conv(c2, B, st);
}
