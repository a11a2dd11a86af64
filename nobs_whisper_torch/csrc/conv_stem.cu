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
// kernel is compute-bound. What holds it above that: the shared memory of
// an SM (128 B a clock) feeds the products (a 128 x 256 tile's wgmma reads
// 80 B a clock at the tensor peak) and takes the TMA's writes (47 more);
// and the epilogue's gelu_tanh with tanhf, ~40 instructions for each of
// 11.5 M outputs at B = 2, about 15 us of the card's issue, two thirds of
// it in conv1, whose products take ~6 us.
//
// Design (sm_90a): three launches from one C entry.
//   1. stem_mel_rows_kernel: the (B, C, n_frames) f32 mel transposed into
//      (B, n_frames, CP) bf16 rows, CP = C rounded up to MEL_CQ channels
//      (16-byte rows for the tensor map), through a shared-memory tile.
//   2. and 3. stem_conv_kernel<BN, STRIDE>, conv1 then conv2: an implicit
//      GEMM per batch row, out[r] = sum over taps j and channels c of
//      in[STRIDE r + j - 1][c] w[j][c] (M = output rows, N = d, K = 3 C),
//      that never forms an im2col. Block tile 128 rows x BN columns, grid
//      (d / BN, rows / 128, B): no tile crosses a batch row. Two MMA
//      warpgroups of 64 rows each; warp 8's first thread issues every
//      load. conv2 takes BN = 256 where d % 256 == 0: a block an SM, 384
//      threads, setmaxnreg moving registers to the MMA warpgroups (224 for
//      the 128 f32 accumulators of a thread) from the third (56), whose
//      warps 9-11 join the epilogue. conv1, whose epilogue is as long as
//      its products, takes BN = 128 (and conv2 where d % 256 != 0): two
//      blocks of 288 threads an SM, so that one block's epilogue overlaps
//      the other's products (StemCfg).
//   * A ring of stages, each one K slab of 64 channels of one tap: the 128
//     input rows (16 KB) and the weight's 64 x BN slab, with a "full"
//     mbarrier (the producer's expect_tx, completed by the TMA's bytes) and
//     an "empty" one (one arrival per MMA warpgroup).
//   * The convs' zero padding is the TMA's out-of-bounds fill. conv1 maps
//     the mel rows as (C, n_frames, B): tap j of output rows r0.. is the
//     box at (c0, r0 + j - 1, b), so rows -1 and n_frames, and channels
//     past C in the last 64-channel slab (C = 80), read as zero. conv2
//     maps conv1's output A (B, n_frames, d) as (d, 2, n_frames / 2, B),
//     the TPU kernel's even / odd row streams (conv_stem.py:13-22) as a
//     view instead of a copy: A[2t - 1] = (c0, 1, t - 1), A[2t] = (c0, 0,
//     t), A[2t + 1] = (c0, 1, t); at t = 0 the left pad is coordinate -1.
//   * The weights as stored: w (3, C, d) is the GEMM's B with N
//     contiguous, mapped as (d, C, 3) in boxes of 64 channels x 64
//     columns, read by wgmma as an MN-major operand (the transpose bit):
//     no copy of any weight. Its descriptor's leading byte offset is the
//     step between the 64-column boxes, its stride byte offset that
//     between 8-channel groups; the channels past C of w1's last slab
//     read as zero as well.
//   * Each MMA warpgroup issues four wgmma.m64nBNk16 a slab (A its 64
//     rows, K-major under the 128-byte swizzle, 32 bytes further each
//     k-step; B 16 channels further each step), commits them as one group,
//     and frees the previous slab's stage once that group has retired
//     (wait_group 1). The accumulators are zeroed before the first group
//     and written only by wgmma after that: ptxas serializes every wgmma
//     (C7515) if another instruction defines one in flight.
//   * The epilogue goes through shared memory: once both MMA warpgroups
//     have read their last slab, they add the bias (read in its own type,
//     f32 or bf16) and store bf16(acc + bias), rg's first rounding, into a
//     tile over the ring; then every epilogue thread takes 8 consecutive
//     columns of a row at a time: the gelu and its rounding, for conv2 the
//     pos add, the zero rows, one 16-byte store. Tiles wholly past the
//     real rows load nothing and write zeros.
//   * conv1's output A (B x n_frames x d bf16, 15.4 MB at B = 2) makes one
//     round trip through device memory, where the TPU kernel keeps it in
//     VMEM: the 50 MB L2 holds it, and at the memory's rate it is under
//     0.01 ms of the 0.036 ms bound.
//   * Tried and not kept (measured in PERF.md): the weight's slabs
//     multicast to clusters of two blocks along M (half the weights' L2
//     traffic; conv2 no faster); persistent blocks whose three epilogue
//     warps overlap the next tile's products (too few for the tanhf); rg
//     from a table of its 5,120 values at 2^-16 <= |bf16(s)| < 16 in
//     shared memory (the same bits, but slower than evaluating it).

#include "common.cuh"
#include "hopper.cuh"

namespace nwt {

constexpr int STEM_BM = 128;         // output rows a block: 2 x 64
constexpr int STEM_BK = 64;          // channels a K slab: one 128-byte row
// the widest tile each conv takes where d allows (else 128 columns)
constexpr int STEM_BN_CONV1 = 128, STEM_BN_CONV2 = 256;
constexpr int MEL_CQ = 8;            // the mel rows' channel quantum
// warp 8's thread 0 issues the loads; warps from STEM_AUX_FIRST / 32 on
// (9-11 in a 256-column tile's block) join the 8 MMA warps' epilogue
constexpr int STEM_AUX_FIRST = 288;
// named barriers (0 is __syncthreads): the two MMA warpgroups; the
// epilogue's threads once the f32 tile is written
constexpr int BAR_MMA = 1, BAR_EPILOGUE = 2;

// A 256-column tile's block takes the SM: 384 threads, 4 stages of 48 KB,
// setmaxnreg. Two 128-column blocks share one: 288 threads (at most 112
// registers a thread, no setmaxnreg; wgmma.m64n128k16 needs 90), 3 stages
// of 32 KB.
template <int BN>
struct StemCfg {
  static constexpr int BLOCKS = BN == 256 ? 1 : 2;        // blocks an SM
  static constexpr int THREADS = BN == 256 ? 384 : 288;
  static constexpr int EPI_THREADS =
      256 + (THREADS > STEM_AUX_FIRST ? THREADS - STEM_AUX_FIRST : 0);
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int MMA_REGS = 224, AUX_REGS = 56;     // BN == 256
  static_assert(256 * MMA_REGS + 128 * AUX_REGS <= 65536, "registers");
  static constexpr int A_BYTES = STEM_BM * STEM_BK * 2;    // 16 KB
  static constexpr int B_BOX = STEM_BK * 64 * 2;          // 64 x 64: 8 KB
  static constexpr int STAGE = A_BYTES + (BN / 64) * B_BOX;
  static constexpr int SMEM = STAGES * STAGE + 1024;       // + alignment
  static constexpr int NACC = BN / 2;                      // f32 a thread
  // the epilogue's bf16 tile over the ring: 128 rows of BN, padded by 8
  // (16 bytes) so that a warp's stores of 8 rows fall in distinct banks
  static constexpr int LD = BN + 8;
  static_assert(STEM_BM * LD * 2 <= STAGES * STAGE, "tile > ring");
};

struct StemArgs {
  const void* bias;   // (N,) f32 (bias_f32) or bf16
  const bf16* pos;    // (>= n_out, N) added after the gelu, or nullptr
  bf16* y;            // (B, rows_out, N)
  int bias_f32;
  int n_out;          // real output rows a batch row
  int rows_out;       // rows of y a batch row, >= n_out; the rest zero
  int N;
  int c_slabs;        // 64-channel slabs a tap: ceil(C / 64)
};

// ---------------------------------------------------------------------------
// The mel pass: (B, C, F) f32 -> (B, F, CP) bf16, channels C..CP-1 zero
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
stem_mel_rows_kernel(const float* __restrict__ mel, bf16* __restrict__ x,
                     int C, int CP, int F) {
  __shared__ float tile[32][33];
  const int f0 = blockIdx.x * 32, c0 = blockIdx.y * 32, b = blockIdx.z;
  const float* mb = mel + (size_t)b * C * F;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int c = c0 + i, f = f0 + threadIdx.x;
    tile[i][threadIdx.x] = c < C && f < F ? mb[(size_t)c * F + f] : 0.f;
  }
  __syncthreads();
  bf16* xb = x + (size_t)b * F * CP;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int f = f0 + i, c = c0 + threadIdx.x;
    if (f < F && c < CP)
      xb[(size_t)f * CP + c] = __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

// ---------------------------------------------------------------------------
// The convs: TMA ring + wgmma (source note above)
// ---------------------------------------------------------------------------

#define STEM_R64                                                      \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                 \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "      \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "      \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "      \
  "%60, %61, %62, %63"
#define STEM_R128                                                         \
  STEM_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, "                    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "  \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "    \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127"
#define STEM_F8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define STEM_F64                                                          \
  STEM_F8(0), STEM_F8(8), STEM_F8(16), STEM_F8(24), STEM_F8(32),          \
      STEM_F8(40), STEM_F8(48), STEM_F8(56)
#define STEM_F128                                                         \
  STEM_F64, STEM_F8(64), STEM_F8(72), STEM_F8(80), STEM_F8(88),           \
      STEM_F8(96), STEM_F8(104), STEM_F8(112), STEM_F8(120)

// D (64 x BN f32) += A (64 x 16, K-major) B (16 x BN, MN-major: the
// transpose bit), both bf16 in shared memory
template <int BN>
__device__ __forceinline__ void wgmma_stem(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{" STEM_R128 "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : STEM_F128
        : "l"(da), "l"(db), "n"(1));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{" STEM_R64 "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : STEM_F64
        : "l"(da), "l"(db), "n"(1));
}

template <int ID>
__device__ __forceinline__ void named_sync(int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "r"(threads) : "memory");
}
// 8 bf16 (16 bytes) <-> 8 f32
__device__ __forceinline__ void unpack8(uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return raw;
}

// STRIDE 1: conv1, tx maps the mel rows (C, F, B). STRIDE 2: conv2, tx
// maps conv1's output as (d, 2, F / 2, B). tw maps w (3, C, d) as (d, C,
// 3). Grid (N / BN, ceil(rows_out / 128), B).
template <int BN, int STRIDE>
__global__ void __launch_bounds__(StemCfg<BN>::THREADS, StemCfg<BN>::BLOCKS)
stem_conv_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw, const StemArgs p) {
  using C = StemCfg<BN>;
  extern __shared__ uint8_t stem_smem[];
  __shared__ __align__(8) uint64_t bars[2 * C::STAGES];   // full, empty
  const uint32_t ring = (smem_u32(stem_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * C::STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * STEM_BM, b = blockIdx.z;
  // a tile wholly past the real rows holds zeros only: no loads, no wgmma
  const int n_slabs = m0 < p.n_out ? 3 * p.c_slabs : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  bf16* tile =
      reinterpret_cast<bf16*>(stem_smem + (ring - smem_u32(stem_smem)));

  if (wg == 2) {
    if constexpr (C::BLOCKS == 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          C::AUX_REGS));
    if (threadIdx.x == 2 * 128) {   // the producer
      for (int it = 0; it < n_slabs; ++it) {
        const int s = it % C::STAGES;
        const int tap = it / p.c_slabs, c0 = (it % p.c_slabs) * STEM_BK;
        if (it >= C::STAGES)
          mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, C::STAGE);
        const uint32_t dst = ring + s * C::STAGE;
        if constexpr (STRIDE == 1)   // rows m0 + tap - 1 ..
          tma_load_3d(dst, &tx, c0, m0 + tap - 1, b, full + 8 * s);
        else   // rows 2t + tap - 1: parity (tap + 1) & 1, t - (tap == 0)
          tma_load_4d(dst, &tx, c0, (tap + 1) & 1, m0 - (tap == 0), b,
                      full + 8 * s);
#pragma unroll
        for (int i = 0; i < BN / 64; ++i)
          tma_load_3d(dst + C::A_BYTES + i * C::B_BOX, &tw, n0 + 64 * i, c0,
                      tap, full + 8 * s);
      }
      return;
    }
    if (threadIdx.x < STEM_AUX_FIRST) return;
  } else {
    if constexpr (C::BLOCKS == 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          C::MMA_REGS));
    float acc[C::NACC];
#pragma unroll
    for (int i = 0; i < C::NACC; ++i) acc[i] = 0.f;
    for (int it = 0; it < n_slabs; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full + 8 * s, (it / C::STAGES) & 1);
      const uint32_t xa = ring + s * C::STAGE + wg * (C::A_BYTES / 2);
      const uint32_t wb = ring + s * C::STAGE + C::A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < STEM_BK / 16; ++kk)   // 16 channels a step
        wgmma_stem<BN>(acc, smem_desc(xa + kk * 32, 1024, 1),
                       smem_desc(wb + kk * 16 * 128, 1024, 1, C::B_BOX));
      wgmma_commit();
      wgmma_wait<1>();   // slab it - 1's group has read its stage
      if (it > 0 && (threadIdx.x & 127) == 0)
        mbar_arrive(empty + 8 * ((it - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // The epilogue. The MMA warpgroups add the bias to their accumulators
    // (4 j + 2 h + e: row 64 wg + 16 warp + lane / 4 + 8 h, column 8 j + 2
    // (lane % 4) + e) and store bf16(acc + bias), rg's first rounding, into
    // a bf16 tile over the ring, once both have read their last slab.
    named_sync<BAR_MMA>(256);
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    bf16* t0 = tile + (wg * 64 + warp * 16 + (lane >> 2)) * C::LD +
               2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane & 3);
      float2 bias;
      if (p.bias_f32)
        bias = *reinterpret_cast<const float2*>(
            static_cast<const float*>(p.bias) + c);
      else
        bias = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const bf16*>(p.bias) + c));
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(t0 + 8 * h * C::LD + 8 * j) =
            __floats2bfloat162_rn(__fadd_rn(acc[4 * j + 2 * h], bias.x),
                                  __fadd_rn(acc[4 * j + 2 * h + 1], bias.y));
    }
  }
  named_sync<BAR_EPILOGUE>(C::EPI_THREADS);   // the tile is written
  // then each of the epilogue's threads takes 8 consecutive columns of a
  // row at a time: 8 independent outputs, one 16-byte store
  constexpr int CPR = BN / 8;   // 8-column chunks a row
  static_assert(C::EPI_THREADS % CPR == 0, "a thread's column is fixed");
  const int e = wg < 2 ? threadIdx.x : threadIdx.x - (STEM_AUX_FIRST - 256);
  const int cc = e % CPR, c = n0 + 8 * cc;
  bf16* yb = p.y + (size_t)b * p.rows_out * p.N + c;
  for (int k = e; k < STEM_BM * CPR; k += C::EPI_THREADS) {
    const int rr = k / CPR, r = m0 + rr;
    if (r >= p.rows_out) break;   // rows only grow with k
    uint4 out = make_uint4(0, 0, 0, 0);
    if (r < p.n_out) {
      float v[8];
      unpack8(*reinterpret_cast<const uint4*>(tile + rr * C::LD + 8 * cc), v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = __bfloat162float(__float2bfloat16_rn(gelu_tanh(v[i])));
      if (p.pos) {
        float ps[8];
        unpack8(*reinterpret_cast<const uint4*>(p.pos + (size_t)r * p.N + c),
                ps);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = __fadd_rn(v[i], ps[i]);
      }
      out = pack8(v);
    }
    *reinterpret_cast<uint4*>(yb + (size_t)r * p.N) = out;
  }
}

// a bf16 tensor map of `rank` dims (dims[0] contiguous; strides in bytes
// of dims 1..rank-1) in boxes `box`, 128-byte swizzle, zero fill
inline bool stem_map(CUtensorMap* map, const void* z, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  EncodeTiledFn enc = encode_tiled();
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc &&
         enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(z), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int STRIDE>
inline cudaError_t launch_stem_conv(const CUtensorMap& tx,
                                    const CUtensorMap& tw, const StemArgs& a,
                                    int B, cudaStream_t st) {
  using C = StemCfg<BN>;
  // at every launch, as launch_attn_wgmma does: no per-library state
  cudaError_t e = cudaFuncSetAttribute(
      stem_conv_kernel<BN, STRIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.N / BN, (a.rows_out + STEM_BM - 1) / STEM_BM, B);
  stem_conv_kernel<BN, STRIDE><<<grid, C::THREADS, C::SMEM, st>>>(tx, tw,
                                                                    a);
  return cudaGetLastError();
}

template <int STRIDE>
inline cudaError_t launch_stem(const CUtensorMap& tx, const CUtensorMap& tw,
                               const StemArgs& a, int B, cudaStream_t st) {
  constexpr int BN = STRIDE == 1 ? STEM_BN_CONV1 : STEM_BN_CONV2;
  return a.N % BN == 0 ? launch_stem_conv<BN, STRIDE>(tx, tw, a, B, st)
                       : launch_stem_conv<128, STRIDE>(tx, tw, a, B, st);
}

}  // namespace nwt

using namespace nwt;

// mel (B, C, n_frames) f32; w1 (3, C, d) and w2 (3, d, d) bf16 as stored;
// b1, b2 (d,) f32 (bias_f32) or bf16; pos (>= n_frames / 2, d) bf16; d %
// 128 == 0, n_frames even, t_out_pad >= n_frames / 2; every pointer 16-byte
// aligned, pos rows of pitch d. Workspace: x (B, n_frames, CP) bf16, CP =
// C rounded up to MEL_CQ, and a (B, n_frames, d) bf16. Writes out (B,
// t_out_pad, d) bf16.
extern "C" int nwt_encoder_stem(const void* mel, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, int bias_f32,
                                const void* pos, void* x, void* a, void* out,
                                int B, int n_frames, int C, int d,
                                int t_out_pad, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int F = n_frames, cp = (C + MEL_CQ - 1) / MEL_CQ * MEL_CQ;
  if (B < 1 || C < 1 || F < 2 || F % 2 || d % 128 || t_out_pad < F / 2)
    return (int)cudaErrorInvalidValue;
  stem_mel_rows_kernel<<<dim3((F + 31) / 32, (cp + 31) / 32, B), dim3(32, 8),
                         0, st>>>(static_cast<const float*>(mel),
                                  static_cast<bf16*>(x), C, cp, F);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const cuuint64_t es = sizeof(bf16);
  CUtensorMap tx, tw1, ta, tw2;
  const cuuint64_t x_dims[3] = {(cuuint64_t)C, (cuuint64_t)F, (cuuint64_t)B};
  const cuuint64_t x_str[2] = {cp * es, (cuuint64_t)F * cp * es};
  const cuuint32_t x_box[3] = {STEM_BK, STEM_BM, 1};
  const cuuint64_t w1_dims[3] = {(cuuint64_t)d, (cuuint64_t)C, 3};
  const cuuint64_t w1_str[2] = {d * es, (cuuint64_t)C * d * es};
  const cuuint64_t a_dims[4] = {(cuuint64_t)d, 2, (cuuint64_t)F / 2,
                                (cuuint64_t)B};
  const cuuint64_t a_str[3] = {d * es, 2 * d * es, (cuuint64_t)F * d * es};
  const cuuint32_t a_box[4] = {STEM_BK, 1, STEM_BM, 1};
  const cuuint64_t w2_dims[3] = {(cuuint64_t)d, (cuuint64_t)d, 3};
  const cuuint64_t w2_str[2] = {d * es, (cuuint64_t)d * d * es};
  const cuuint32_t w_box[3] = {64, STEM_BK, 1};
  if (!stem_map(&tx, x, 3, x_dims, x_str, x_box) ||
      !stem_map(&tw1, w1, 3, w1_dims, w1_str, w_box) ||
      !stem_map(&ta, a, 4, a_dims, a_str, a_box) ||
      !stem_map(&tw2, w2, 3, w2_dims, w2_str, w_box))
    return (int)cudaErrorInvalidValue;

  StemArgs c1{b1, nullptr, static_cast<bf16*>(a), bias_f32, F, F, d,
              (C + STEM_BK - 1) / STEM_BK};
  e = launch_stem<1>(tx, tw1, c1, B, st);
  if (e != cudaSuccess) return (int)e;
  StemArgs c2{b2, static_cast<const bf16*>(pos), static_cast<bf16*>(out),
              bias_f32, F / 2, t_out_pad, d, d / STEM_BK};
  return (int)launch_stem<2>(ta, tw2, c2, B, st);
}
