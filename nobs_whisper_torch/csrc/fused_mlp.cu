// K2 and K8: out = x + fc2(requant(gelu_tanh(fc1(quant(LN2 x))))) + b2
// with int8 weights, per-row int8 activations and the fc2 input
// re-quantized per (row, FFN chunk).
//
// Replaces two TPU kernels of nobs_whisper_tpu/ops/fused_mlp.py, both
// hand-written here, neither a library call:
//   K2 nwt_encoder_mlp_int8[_f32]: encoder_mlp_int8_resident (pallas_call at
//      :298, kernel _enc_mlp_res_kernel :211), the quantized encoder's
//      default MLP, block_f 2560 at its call site (whisper.py:551);
//   K8 nwt_encoder_mlp_int8_chunked[_f32]: encoder_mlp_int8 (pallas_call at
//      :173, kernel _enc_mlp_kernel :94), taken under NWT_MLP_CHUNKED with
//      block_f 1280.
// The two TPU kernels compute one function (tests/test_fused_mlp.py:81-108
// holds them equal at equal block_f): "resident" keeps the whole w1/w2 in
// VMEM across the row tiles, "chunked" streams them chunk by chunk. That is
// a VMEM residency choice with no counterpart on this card, where every
// block reads its weight tiles through L2. What K8 changes is the
// function's one parameter: the granularity block_f at which the fc2 input
// is re-quantized. So K8 is its own entry point, counted on its own, on the
// same templated kernels below; K12's MLP half (fused_layer.cu) calls the
// same template.
//
// Numerics, op for op those of the TPU kernel and of the port's plain
// version (ops/fused_mlp.py::mlp_int8_plain): LN in f32 (eps 1e-5), the row
// scale max(absmax, 1e-6) / 127; fc1's int32 sum, then (acc s_row) s_col +
// b1 with _rn intrinsics and the tanh gelu on tanhf (common.cuh's
// gelu_tanh); the per-(row, chunk) scale max(amax, 1e-6) / 127 and
// aq = clip(rint(a / s)); fc2's int32 sum of each chunk flushed into an f32
// accumulator that starts at x + b2, as (acc s_rc) s2, chunks in order.
// Every int32 product is exact and the absmax is a max, so the result does
// not depend on the order of the sums: these kernels give the bits of the
// port's first, mma.sync version (tests/goldens/fused_mlp_mma_sync.cu).
//
// Bound on an H100 at large-v3-turbo (M = 3072 rows for a batch of two
// windows, d = 1280, ffn = 5120): 80.5 G int8 operations, 0.0407 ms at the
// published int8 tensor-core peak; x, out and the weights, about 29 MB,
// 0.009 ms: the kernel is compute-bound. What holds it above that (PERF.md
// has the split): fc1's tiles are short in K (d = 1280, 10 slabs), so each
// block pays its ring's first loads, a cluster barrier and its epilogue
// with the tensor cores idle; the epilogue's tanh gelu on tanhf, 15.7 M
// values, about 0.021 ms of the whole card's issue, runs after the
// block's products and not beside them; fc2's 240 tiles are 1.8 waves of
// the 132 SMs, and its wgmma n128 reads 96 B a clock of shared memory at
// the tensor peak beside the TMA's 64, more than the SM's 128.
//
// Design (sm_90a), the GEMMs on gemm_s8_wgmma.cuh's TMA ring and int8
// wgmma; the weights as their K-major copies w1t (F, d) and w2t (d, F),
// made once per weight by the wrapper. Every GEMM kernel runs a block an
// SM: 384 threads, the third warpgroup the producer, setmaxnreg moving its
// registers to the two consumer warpgroups (64 rows each).
//   1. ln_quant_kernel (common.cuh): LN2 + per-row quant of x.
//   2. mlp_fc1_cluster_kernel<BN>: fc1 with the requantization in its
//      epilogue. A block takes 128 rows x BN columns; a thread-block
//      cluster of block_f / BN blocks along x covers one chunk of a row
//      tile (FC1_BN_WIDE, 160 columns, where block_f / 160 is a cluster of
//      at most MLP_MAX_CLUSTER (16) blocks, else FC1_BN, 128: block_f 2560
//      is 16 blocks, 1280 is 8, 640 is 4, 256 is 2 of 128). Each block
//      dequantizes, adds b1 and applies the gelu in registers, reduces each
//      row's absmax over its columns (a quad of lanes holds a row), writes
//      its row maxima to shared memory, waits at the cluster barrier, reads
//      the peers' maxima over distributed shared memory, quantizes its own
//      tile into an int8 tile in shared memory and stores it with 16-byte
//      stores; the cluster's rank 0 writes each row's chunk absmax (float
//      bits). No f32 (M, ffn) intermediate, no memset, no requant launch.
//      The card holds 7 clusters of 16 at once (112 SMs), 15 of 8.
//   3. mlp_fc2_kernel (proj_wgmma.cuh, which K1's fused o projection
//      launches too): fc2 on 128 x 128 tiles (its f32 accumulator beside
//      the int32 one leaves no registers for wider tiles), 6 ring stages
//      of 32 KB. The f32 accumulator starts at x + b2; at each chunk
//      boundary the slab's group is retired (wait_group 0) and the int32
//      sum is added into it scaled by the row-chunk scale and s2; the next
//      chunk's first step restarts the int32 sum (scale-d = 0). The output
//      goes through shared memory to 16-byte stores.
//   A chunk that no cluster of at most 16 blocks covers (block_f > 2048
//   unless 160 divides it into at most 16: at ffn 5120 only block_f 5120)
//   takes the two-pass variant: mlp_fc1_twopass_kernel writes the f32
//   gelu output and each row's chunk absmax by atomicMax on the float bits
//   (non-negative floats order like their bit patterns; the amax workspace
//   zeroed first), requant_kernel quantizes it, then the same fc2.
//   Tried and not kept (PERF.md): 320-column tiles (two wgmma n160 a
//   warpgroup: 160 accumulators a thread, and ptxas serializes the
//   wgmma), two 64-row blocks an SM, TMA multicast of the shared tiles
//   across the cluster, and a persistent fc1 whose two consumer
//   warpgroups take row tiles in turn with the block's w1 columns resident
//   in shared memory.
//
// Activations are bf16 (nwt_encoder_mlp_int8) or f32
// (nwt_encoder_mlp_int8_f32): the reference gates K2 on no dtype, so an
// int8 encoder at f32 compute runs it too. Only the types of x and out
// differ (ln_quant_kernel and mlp_fc2_kernel are templated on them); the
// arithmetic is f32 in both, as in the TPU kernel (x cast to f32, the
// accumulator cast to out's type at the end).

#include "proj_wgmma.cuh"

namespace nwt {

// fc1's tile widths and the largest cluster (the non-portable 16); fc2,
// its ring and its tile: proj_wgmma.cuh
constexpr int FC1_BN_WIDE = 160, FC1_BN = 128, MLP_MAX_CLUSTER = 16;

// fc1's tile width and cluster size for chunk width block_f; cluster 0:
// no cluster covers the chunk, the two-pass variant (FC1_BN columns)
inline void fc1_plan(int block_f, int& bn, int& cluster) {
  if (block_f % FC1_BN_WIDE == 0 && block_f / FC1_BN_WIDE <= MLP_MAX_CLUSTER) {
    bn = FC1_BN_WIDE;
    cluster = block_f / FC1_BN_WIDE;
  } else {
    bn = FC1_BN;
    cluster = block_f / FC1_BN <= MLP_MAX_CLUSTER ? block_f / FC1_BN : 0;
  }
}

// the float at the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(cluster_addr(smem_u32(p), rank)) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// fc1: on the cluster path with the requantization in its epilogue; on the
// two-pass variant with its f32 output and the chunk absmax
// ---------------------------------------------------------------------------

struct FC1Args {
  const float* sx;       // (M,) row scales of xq
  const float* s1;       // (F,) column scales
  const float* b1;       // (F,)
  int8_t* aq;            // cluster path: (M, F) int8 fc2 input
  float* a;              // two-pass: (M, F) f32 gelu output
  unsigned* amax;        // (M, F / block_f) float bits of each chunk absmax
  int M, d, F, block_f;
};

// ta maps xq (M, d), tb maps w1t (F, d), both in boxes of 128 rows x 128
// bytes. Grid (F / BN, ceil(M / 128)), clusters of block_f / BN blocks
// along x: a cluster covers one chunk of a row tile.
template <int BN>
__global__ void __launch_bounds__(G8Cfg::THREADS, 1)
mlp_fc1_cluster_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb,
                       const FC1Args p) {
  using L = G8Tile<BN>;
  constexpr int STAGES = ring_stages(BN);
  extern __shared__ uint8_t fc1_smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, empty
  __shared__ float rowmax[128], rowamax[128];
  const uint32_t ring = (smem_u32(fc1_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * 128;
  const int n_slabs = p.d / G8_BK;
  if (threadIdx.x == 0) g8_init_bars<STAGES>(full, empty);
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G8Cfg::PRODUCER_REGS));
    if (threadIdx.x == L::PRODUCER)
      g8_produce<BN, STAGES>(&ta, &tb, ring, full, empty, n_slabs, m0,
                                  n0);
    __syncwarp();
    cluster_sync();   // it takes part in the cluster's two barriers
    cluster_sync();
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      G8Cfg::CONSUMER_REGS));

  uint32_t acc[L::NACC];
#pragma unroll
  for (int i = 0; i < L::NACC; ++i) acc[i] = 0;
  for (int it = 0; it < n_slabs; ++it) {
    g8_mma_slab<BN, STAGES>(acc, ring, full, it, wg, false);
    wgmma_wait<1>();   // slab it - 1's group has read its stage
    if (it > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // dequantize, b1, gelu, in registers; each row's absmax over the tile
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);   // rows rl, rl + 8
  const int n_chunks = p.F / p.block_f, chunk = n0 / p.block_f;
  float sxr[2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sxr[h] = m0 + rl + 8 * h < p.M ? p.sx[m0 + rl + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    const float2 s = *reinterpret_cast<const float2*>(p.s1 + c);
    const float2 bb = *reinterpret_cast<const float2*>(p.b1 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h;
      const float v0 = gelu_tanh(
          __fadd_rn(dequant((int)acc[i], sxr[h], s.x), bb.x));
      const float v1 = gelu_tanh(
          __fadd_rn(dequant((int)acc[i + 1], sxr[h], s.y), bb.y));
      mx[h] = fmaxf(mx[h], fmaxf(fabsf(v0), fabsf(v1)));
      acc[i] = __float_as_uint(v0);
      acc[i + 1] = __float_as_uint(v1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // a quad's 4 lanes share rows
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  if ((lane & 3) == 0) {
    rowmax[rl] = mx[0];
    rowmax[rl + 8] = mx[1];
  }
  cluster_sync();   // every block's row maxima are written
  if (threadIdx.x < 128) {   // row threadIdx.x: the max over the cluster
    const unsigned n = cluster_size();
    float m = 0.f;
    for (unsigned k = 0; k < n; ++k)
      m = fmaxf(m, ld_cluster(rowmax + threadIdx.x, k));
    rowamax[threadIdx.x] = m;
    const int r = m0 + threadIdx.x;
    if (cluster_rank() == 0 && r < p.M)
      p.amax[(size_t)r * n_chunks + chunk] = __float_as_uint(m);
  }
  g8_bar<BAR_CONSUMERS>(256);

  // quantize into an int8 tile over the ring (every stage was read), then
  // 16-byte stores of whole rows
  constexpr int LD = BN + 16;
  static_assert(128 * LD <= STAGES * L::STAGE, "tile > ring");
  int8_t* tile =
      reinterpret_cast<int8_t*>(fc1_smem + (ring - smem_u32(fc1_smem)));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float s = __fdiv_rn(fmaxf(rowamax[rl + 8 * h], 1e-6f), 127.0f);
    int8_t* t = tile + (rl + 8 * h) * LD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int i = 4 * j + 2 * h;
      char2 q;
      q.x = quant_s8(__uint_as_float(acc[i]), s);
      q.y = quant_s8(__uint_as_float(acc[i + 1]), s);
      *reinterpret_cast<char2*>(t + 8 * j) = q;
    }
  }
  g8_bar<BAR_CONSUMERS>(256);
  constexpr int CPR = BN / 16;   // 16-byte pieces a row
  for (int k = threadIdx.x; k < 128 * CPR; k += 256) {
    const int rr = k / CPR, cc = k % CPR, r = m0 + rr;
    if (r < p.M)
      *reinterpret_cast<int4*>(p.aq + (size_t)r * p.F + n0 + 16 * cc) =
          *reinterpret_cast<const int4*>(tile + rr * LD + 16 * cc);
  }
  cluster_sync();   // no block leaves while a peer reads its row maxima
}

// ta maps xq (M, d), tb maps w1t (F, d), both in boxes of 128 rows. Grid
// (F / 128, ceil(M / 128)).
__global__ void __launch_bounds__(G8Cfg::THREADS, 1)
mlp_fc1_twopass_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb, const FC1Args p) {
  using L = G8Tile<FC1_BN>;
  constexpr int STAGES = ring_stages(FC1_BN);
  extern __shared__ uint8_t fc1_smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];   // full, empty
  const uint32_t ring = (smem_u32(fc1_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * STAGES;
  const int n0 = blockIdx.x * FC1_BN, m0 = blockIdx.y * 128;
  const int n_slabs = p.d / G8_BK;
  if (threadIdx.x == 0) g8_init_bars<STAGES>(full, empty);
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {   // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        G8Cfg::PRODUCER_REGS));
    if (threadIdx.x == L::PRODUCER)
      g8_produce<FC1_BN, STAGES>(&ta, &tb, ring, full, empty, n_slabs,
                                      m0, n0);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      G8Cfg::CONSUMER_REGS));

  uint32_t acc[L::NACC];
#pragma unroll
  for (int i = 0; i < L::NACC; ++i) acc[i] = 0;
  for (int it = 0; it < n_slabs; ++it) {
    g8_mma_slab<FC1_BN, STAGES>(acc, ring, full, it, wg, false);
    wgmma_wait<1>();   // slab it - 1's group has read its stage
    if (it > 0 && (threadIdx.x & 127) == 0)
      mbar_arrive(empty + 8 * ((it - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int rl = wg * 64 + warp * 16 + (lane >> 2);   // rows rl, rl + 8
  const int n_chunks = p.F / p.block_f, chunk = n0 / p.block_f;
  float sxr[2], mx[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sxr[h] = m0 + rl + 8 * h < p.M ? p.sx[m0 + rl + 8 * h] : 0.f;
#pragma unroll
  for (int j = 0; j < FC1_BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    const float2 s = *reinterpret_cast<const float2*>(p.s1 + c);
    const float2 bb = *reinterpret_cast<const float2*>(p.b1 + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * j + 2 * h, r = m0 + rl + 8 * h;
      const float v0 = gelu_tanh(
          __fadd_rn(dequant((int)acc[i], sxr[h], s.x), bb.x));
      const float v1 = gelu_tanh(
          __fadd_rn(dequant((int)acc[i + 1], sxr[h], s.y), bb.y));
      mx[h] = fmaxf(mx[h], fmaxf(fabsf(v0), fabsf(v1)));
      if (r < p.M)
        *reinterpret_cast<float2*>(p.a + (size_t)r * p.F + c) =
            make_float2(v0, v1);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // a quad's 4 lanes share rows
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const int r = m0 + rl + 8 * h;
    if ((lane & 3) == 0 && r < p.M)
      atomicMax(p.amax + (size_t)r * n_chunks + chunk, __float_as_uint(mx[h]));
  }
}

// the two-pass variant's fc2 input: aq = clip(rint(a / s)) with s the
// (row, chunk) scale; four consecutive values per thread (a chunk is a
// multiple of 128 wide)
__global__ void __launch_bounds__(256)
requant_kernel(const float* __restrict__ a, const unsigned* __restrict__ amax,
               int8_t* __restrict__ aq, int M, int F, int block_f) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= (size_t)M * F) return;
  const int r = (int)(i / F), c = (int)(i % F);
  const float s = chunk_scale(amax, r, F / block_f, c / block_f);
  const float4 v = *reinterpret_cast<const float4*>(a + i);
  *reinterpret_cast<uint32_t*>(aq + i) =
      (uint32_t)(uint8_t)quant_s8(v.x, s) |
      ((uint32_t)(uint8_t)quant_s8(v.y, s) << 8) |
      ((uint32_t)(uint8_t)quant_s8(v.z, s) << 16) |
      ((uint32_t)(uint8_t)quant_s8(v.w, s) << 24);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// at every launch, the kernel's attributes: no per-library state (K12's
// library includes this file beside encoder_attention.cu)
template <int BN>
inline cudaError_t launch_fc1_cluster(const CUtensorMap& ta,
                                      const CUtensorMap& tb,
                                      const FC1Args& a, int cluster,
                                      cudaStream_t st) {
  auto kernel = mlp_fc1_cluster_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, ring_smem(BN));
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.F / BN, (a.M + 127) / 128);
  cfg.blockDim = dim3(G8Cfg::THREADS);
  cfg.dynamicSmemBytes = ring_smem(BN);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, ta, tb, a);
}

inline cudaError_t launch_fc1_twopass(const CUtensorMap& ta,
                                      const CUtensorMap& tb,
                                      const FC1Args& a, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      mlp_fc1_twopass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring_smem(FC1_BN));
  if (e != cudaSuccess) return e;
  mlp_fc1_twopass_kernel<<<dim3(a.F / FC1_BN, (a.M + 127) / 128),
                           G8Cfg::THREADS, ring_smem(FC1_BN), st>>>(ta, tb,
                                                                     a);
  return cudaGetLastError();
}

// x (M, d) of type T (bf16, or float for the int8 encoder at f32 compute);
// w1t (F, d) and w2t (d, F): the int8 weights' K-major copies (the
// transposes of the reference's (d_in, d_out) w1 and w2), with f32 column
// scales s1 (F,), s2 (d,); ln_g, ln_b, b2 (d,), b1 (F,) f32. d % 128 == 0,
// F % block_f == 0, block_f % 128 == 0; every pointer 16-byte aligned.
// Workspace: xq (M, d) int8, sx (M,) f32, amax (M, F / block_f) u32, aq (M,
// F) int8, and on the two-pass variant only (fc1_plan gives cluster 0) a
// (M, F) f32 (else unused). Writes out (M, d) of type T.
template <typename T>
int encoder_mlp_int8(
    const void* x, const void* ln_g, const void* ln_b,
    const void* w1t, const void* s1, const void* b1,
    const void* w2t, const void* s2, const void* b2,
    void* out, void* xq, void* sx, void* a, void* amax, void* aq,
    int M, int d, int F, int block_f, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (M < 1 || d % G8_BK || block_f < 128 || block_f % 128 || F % block_f)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_ln_quant(
      static_cast<const T*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return (int)e;

  int bn, cluster;
  fc1_plan(block_f, bn, cluster);
  CUtensorMap txq, tw1, taq, tw2;
  if (!g8_map(&txq, xq, d, M, d, 128) ||
      !g8_map(&tw1, w1t, d, F, d, bn) ||
      !g8_map(&taq, aq, F, M, F, 128) || !g8_map(&tw2, w2t, F, d, F, FC2_BN))
    return (int)cudaErrorInvalidValue;

  FC1Args f1;
  f1.sx = static_cast<const float*>(sx);
  f1.s1 = static_cast<const float*>(s1);
  f1.b1 = static_cast<const float*>(b1);
  f1.aq = static_cast<int8_t*>(aq);
  f1.a = static_cast<float*>(a);
  f1.amax = static_cast<unsigned*>(amax);
  f1.M = M;
  f1.d = d;
  f1.F = F;
  f1.block_f = block_f;
  if (cluster == 0) {   // the two-pass variant
    e = cudaMemsetAsync(amax, 0, (size_t)M * (F / block_f) * sizeof(unsigned),
                        st);
    if (e == cudaSuccess) e = launch_fc1_twopass(txq, tw1, f1, st);
    if (e != cudaSuccess) return (int)e;
    const size_t n4 = (size_t)M * F / 4;
    requant_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(a), static_cast<const unsigned*>(amax),
        static_cast<int8_t*>(aq), M, F, block_f);
    e = cudaGetLastError();
  } else if (bn == FC1_BN_WIDE) {
    e = launch_fc1_cluster<FC1_BN_WIDE>(txq, tw1, f1, cluster, st);
  } else {
    e = launch_fc1_cluster<FC1_BN>(txq, tw1, f1, cluster, st);
  }
  if (e != cudaSuccess) return (int)e;

  MlpFC2Args<T> f2;
  f2.amax = static_cast<const unsigned*>(amax);
  f2.sa = nullptr;
  f2.s2 = static_cast<const float*>(s2);
  f2.b2 = static_cast<const float*>(b2);
  f2.x = static_cast<const T*>(x);
  f2.out = static_cast<T*>(out);
  f2.M = M;
  f2.d = d;
  f2.F = F;
  f2.block_f = block_f;
  return (int)launch_fc2(taq, tw2, f2, st);
}

}  // namespace nwt

using namespace nwt;

#define NWT_MLP_ARGS                                                      \
  const void *x, const void *ln_g, const void *ln_b, const void *w1t,     \
      const void *s1, const void *b1, const void *w2t, const void *s2,    \
      const void *b2, void *out, void *xq, void *sx, void *a, void *amax, \
      void *aq, int M, int d, int F, int block_f, void *stream
#define NWT_MLP_PASS \
  x, ln_g, ln_b, w1t, s1, b1, w2t, s2, b2, out, xq, sx, a, amax, aq, M, d, \
      F, block_f, stream

extern "C" int nwt_encoder_mlp_int8(NWT_MLP_ARGS) {
  return encoder_mlp_int8<bf16>(NWT_MLP_PASS);
}

// the same function on f32 activations: the arithmetic is f32 throughout
// already; only the residual read and the output write change type
extern "C" int nwt_encoder_mlp_int8_f32(NWT_MLP_ARGS) {
  return encoder_mlp_int8<float>(NWT_MLP_PASS);
}

// K8: the chunked kernel's entry points (its default block_f is 1280)
extern "C" int nwt_encoder_mlp_int8_chunked(NWT_MLP_ARGS) {
  return encoder_mlp_int8<bf16>(NWT_MLP_PASS);
}

extern "C" int nwt_encoder_mlp_int8_chunked_f32(NWT_MLP_ARGS) {
  return encoder_mlp_int8<float>(NWT_MLP_PASS);
}
