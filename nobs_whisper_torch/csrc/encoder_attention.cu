// Encoder self-attention: non-causal softmax attention per head, keys >=
// n_real masked. Three entry points share one bf16 attention kernel for
// Hopper (attn_wgmma_kernel, templated on the head width and the output
// type); the opt-in int8 variants keep their own kernel (attn_i8_kernel):
//
//   K1 nwt_encoder_attention_fused_qkv: LN1 -> per-row int8 quant -> int8
//      q/k/v projections -> attention, flat (B, T, d) layout; with the o
//      projection and the residual fused (NWT_ATTN_FUSED=2). Replaces
//      nobs_whisper_tpu/ops/encoder_attention.py::encoder_attention_fused_qkv
//      (pallas_call at :565, kernel _attn_kernel_btd_fused :370 with
//      _make_scores :203 and _make_pv :292).
//   K3 nwt_encoder_attention_btd (nwt_encoder_attention_btd_int8 for the
//      int8 variants): attention on projected bf16 q/k/v in the flat
//      (B, T, d) layout. Replaces encoder_attention_btd (pallas_call at
//      :185, kernel _attn_kernel_btd :105), the float bf16 encoder's default.
//   K9 nwt_encoder_attention_bhtd: the same on per-head (B, H, T, dh)
//      tensors. Replaces encoder_attention (pallas_call at :93, kernel
//      _attn_kernel :35), taken where heads do not pair into 128 lanes.
// fused_layer.cu (K12) calls K1's host function with the o projection fused.
//
// Bounds on an H100 at large-v3-turbo (T = 1536 padded, n_real = 1500,
// d = 1280, H = 20, dh = 64), per window and layer: QK^T and PV are
// 11.8 GFLOP bf16 over the real keys, about 12 us at the published bf16
// tensor-core peak; K3 and K9 move 4 x 3.9 MB of q/k/v/out, about 4.7 us, so
// they are compute-bound. K1 adds 15.1 G int8 operations in the
// projections (about 20 us in all; its bytes about 3.8 us), and 5.0 G more
// with the o projection fused. The int8 variants run QK^T or PV at the int8
// rate, twice bf16's.
//
// Why two passes over the keys. The TPU kernels compute the exact softmax
// of the whole key row: m = max over all keys, p = exp(s - m) in f32,
// l = sum p, o = (bf16(p) @ v, summed in f32) / l (encoder_attention.py:
// 35-72). K and V of one head at T = 1536 (2 x 196 KB at dh = 64) do not
// fit in shared memory, and a one-pass online softmax would round bf16(p)
// against a running max instead of the final one: another function. So
// the first pass streams K and keeps the row max; the second streams K and
// V again and computes p exactly as the TPU kernels do, its sum and the PV
// product. The second QK^T costs 1.5x a one-pass kernel's GEMM work (K3 at
// turbo, B = 2: 35.4 instead of 23.6 GFLOP, a floor of about 0.036 ms at
// the bf16 peak).
//
// attn_wgmma_kernel (sm_90a), every bf16 launch of K1, K3, K9 and K12:
//   * Grid (ceil(T / 128), H, B), 384 threads: two consumer warpgroups of
//     64 query rows (warps 0-3 and 4-7) and a producer warpgroup (one
//     thread issues every load), so each staged K/V tile serves 128 query
//     rows. setmaxnreg moves registers from the producer (40) to the
//     consumers (232): 384 threads leave 168 a thread, too few for dh =
//     128's O (64 f32) beside an S tile in flight. Where T % 128 == 64 the
//     last block's second warpgroup has no rows and leaves at once; the
//     ring's "empty" barriers count the warpgroups that stay.
//   * Layouts: K and V of every head are rows of one 2-D bf16 matrix whose
//     row pitch is its width: the flat (B T, d) layout with head h at
//     column h dh, or the per-head (B H T, dh) one. The C entry point builds
//     one tensor map each for K and V (cuTensorMapEncodeTiled, fetched with
//     cudaGetDriverEntryPoint, so nothing links libcuda) and passes them as
//     __grid_constant__ parameters. A box is 64 keys by min(dh, 64)
//     columns: 128-byte rows under SWIZZLE_128B (dh = 64; dh = 128 loads
//     two boxes side by side), 64-byte rows under SWIZZLE_64B (dh = 32).
//   * The ring: NSTAGE stages of one K and one V tile, each stage with a
//     "full" mbarrier (the producer's expect_tx, completed by the TMA's
//     bytes) and an "empty" one (one arrival per consumer warpgroup). One
//     thread of the producer warpgroup walks the loads of both passes in
//     order: n_tiles K tiles, then n_tiles K + V tiles. Tiles wholly past
//     n_real are never loaded (their p is exactly 0). A wait that never
//     ends traps (an error at the next sync) instead of hanging the card.
//   * Q: each consumer warpgroup loads its 64 rows once, scaled on the way
//     in, bf16(f32(q) * scale) (the TPU kernels' rounding; K1 passes 1.0,
//     its q being scaled already), and stores them in shared memory laid
//     out and swizzled as the TMA lays out a K tile.
//   * S = Q K^T: wgmma.m64n64k16 with A = the q tile and B = the K tile as
//     it lies (both K-major in shared memory; a 16-deep step starts 32
//     bytes further into the swizzled rows). Kept out of registers, q
//     leaves them to O and S.
//   * O += bf16(P) V: wgmma.m64n64k16 (m64n32k16 at dh = 32) with A = p
//     packed pairwise from the S accumulator in registers (the
//     accumulator's layout is the A fragment's) and B = the V tile as it
//     lies, [key][dh], read MN-major through the transpose bit: no
//     transpose pass. dh = 128 issues one product per 64-column box.
//   * Overlap. Pass 1 issues two tiles' QK^T, takes the first's max while
//     the second's runs. Pass 2 follows FlashAttention-3: tile kt's QK^T
//     and tile kt - 1's PV are issued together, and tile kt's exp and sum
//     run while the tensor cores finish that PV; bf16(p) is packed once it
//     is done. The two warpgroups' warps share each SM sub-partition and
//     fill each other's waits (an explicit ping-pong between them with
//     named barriers measured no faster).
//   * ptxas serializes every wgmma (C7515) if an instruction other than a
//     wgmma defines an accumulator register while one is in flight: a
//     register copy where two control paths meet is enough. So the first
//     16-deep step of each QK^T writes S as an output only, O is zeroed
//     while nothing is in flight and then only accumulated, every loop
//     retires its groups before its back edge, and the key mask is selects
//     on the peeled last tile.
//   * p = exp(s - m) on the SFU: ex2.approx.ftz of (s - m) log2 e, within
//     ~1e-6 of the accurate expf (the plain version's torch.exp) and far
//     under the bf16 rounding of p that follows (chip_smoke.py and the
//     on-card tests hold every shape to one bf16 step of the plain
//     version); keys >= n_real at -1e30 in the last tile; l is summed in
//     f32 from the unrounded p; o / l leaves from registers as bf16, or f32
//     (OutT) for K1 with the o projection fused and for K12. Padded query
//     rows see real keys only, so their output is finite.

// The rest of K1 and the int8 variants:
//   1. ln_quant_kernel (common.cuh, K1 only). The TPU kernel computes LN +
//      quant once per batch row into scratch that its later head-pair grid
//      steps reuse (encoder_attention.py:416-433). GPU blocks run in
//      parallel and in no order, so this is a separate pass writing int8
//      rows + scales.
//   2. qkv_gemm_kernel (common.cuh, shared with K10): the three
//      projections as one int8 mma.sync GEMM launch (grid.z picks q, k or
//      v). The epilogue dequantizes (acc * s_row * s_col + bias) and writes
//      bf16(q * dh^-0.5), bf16(k), bf16(v) -- exactly the operands the TPU
//      kernel feeds its bf16 dots; under int8 scores q stays f32 and
//      unscaled, as the TPU kernel quantizes it (:443, :455). The outputs
//      make one round trip through device memory (3 x B x T x d), which the
//      TPU kernel keeps in VMEM.
//   3. The int8 variants' preparation (int8_prep): q quantized per (row,
//      head), divided by its scale max(absmax, 1e-6) / 127; k and v per
//      (batch row, head), times the reciprocal of max(absmax over rows <
//      n_real, 1e-6) / 127 (:225-241, :306-322). The per-head absmax needs
//      every real row before any score: one pass takes it with atomicMax on
//      the float bits (non-negative floats order like their bit patterns,
//      so the result is exact and independent of order), a second
//      quantizes. The TPU kernel holds a head pair's whole K and V in VMEM
//      and takes the statistic there.
//   4. attn_i8_kernel: the int8 scores and PV variants (NWT_ATTN_I8,
//      NWT_ATTN_I8PV; the flat path, dh = 64) keep the port's first
//      design: one block of 4 warps per 64 query rows, mma.sync, the same
//      two passes over 64-key tiles loaded synchronously into padded shared
//      memory, V transposed into Vt as it is stored. int8 wgmma takes
//      K-major B operands only, so int8 PV needs a V layout of its own.
//      int8 scores: m16n8k32 on int8 q and k; the int32 dot over dh = 64
//      is exact, then s = f32(dot) * (sq * (sk * scale)). int8 PV: pq =
//      rint(p * 127) as int8, PV on m16n8k32 against int8 v, the
//      normaliser the integer sum of pq (exact), o = (f32(dot) / max(sum,
//      1)) * sv. The PV operand's key order inside each 32-key step is
//      permuted (key_slot) so that the probabilities, which the scores'
//      accumulator layout leaves two keys per 8-key group in each thread,
//      are the A fragment as they lie; the int32 sum does not depend on
//      the order.
//   5. K1 with the o projection (NWT_ATTN_FUSED=2): the attention writes
//      its normalised output in f32 (the TPU kernel requantizes the f32
//      pair tile, :466); ln_quant_kernel without LN quantizes each (row,
//      head pair) of 128 columns; fc2_gemm_kernel (common.cuh) runs the o
//      projection from f32(x) + bo, flushing its int32 accumulator with
//      each 128-deep slice's row scale, slices in order: the TPU kernel's
//      pair-by-pair sum (:470-476, :490-493), with no atomics. The f32
//      attention output and its int8 copy go through device memory (the
//      TPU kernel keeps the accumulator in VMEM).
//
// What differs from the TPU kernels: they pair two dh = 64 heads into a
// 128-lane block and zero the other head's q lanes (K1, K3), because the
// TPU's lanes are 128 wide; here a head is a warpgroup's wgmma tile of any
// width the kernel is built for (dh = 32, 64 or 128; the int8 variants, on
// the paired path only, dh = 64), so no pairing and no masked dots. Their
// query blocks of 256 rows are 128 here (64 for the int8 variants): the
// rows of a block share one K/V tile stream through shared memory.

#include "common.cuh"

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

namespace nwt {

constexpr int AQ = 64;      // query rows per warpgroup (wgmma) or int8 block
constexpr int AK = 64;      // keys per tile
constexpr int VLD = AK + 8; // padded Vt row (36 words): no bank conflicts
constexpr int KLD8 = 64 + 16;  // padded int8 row (20 words): no conflicts

enum : int { I8_SCORES = 1, I8_PV = 2, FUSE_O = 4 };   // entry points' flags

// One (batch row, head) per blockIdx.(z, y). Strides in elements: a head's
// row t of batch row b starts at b * sb + h * sh + t * st (flat (B, T, d):
// sb = T d, sh = dh, st = d; per head (B, H, T, dh): sb = H T dh, sh = T dh,
// st = dh).
struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  void* o;         // bf16, or f32 for the fused o projection
  long long sb, sh, st;
  int n_real;
  float q_scale;   // q enters the scores as bf16(f32(q) * q_scale); with
                   // int8 scores the softmax scale of sq * (sk * scale)
  // int8 variants (flat layout, dh = 64): q quantized per (row, head) with
  // scales qs[(b T + t) H + h]; k and v quantized per (b, h) from the
  // absmax bits kamax[b H + h], vamax[b H + h]
  const int8_t* qq;
  const float* qs;
  const int8_t* kq;
  const int8_t* vq;
  const unsigned* kamax;
  const unsigned* vamax;
  int T, H;
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

// ---------------------------------------------------------------------------
// Hopper building blocks: mbarriers, TMA, wgmma (inline PTX, sm_90a)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed; a wait that
// never ends (a fault in the ring's protocol) traps instead of hanging
// the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// one box of a 2-D tensor map (column c0, row c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, stride byte offset (the
// step between 8-row groups) and the swizzle (1: 128 B, 2: 64 B). The
// leading byte offset is unused: every operand here is one swizzle atom
// wide in its contiguous dimension.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator or
// fragment registers across the wgmma issue and wait asm statements.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define NWT_ACC16(C)                                                    \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
      C(d[15])
#define NWT_ACC32(C)                                                      \
  NWT_ACC16(C), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]),        \
      C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]),        \
      C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define NWT_WGMMA_SS                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"

// S = Q K^T: D (64 x 64 f32) = A B + (ACC ? D : 0), A (64 x 16) and B
// (16 x 64) both K-major in shared memory. With ACC = 0 the accumulator
// is an output only, so ptxas sees no other instruction define it inside
// a pipeline stage (it would serialize the wgmma).
template <int ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (ACC)
    asm volatile(NWT_WGMMA_SS : NWT_ACC32("+f") : "l"(da), "l"(db), "n"(1));
  else
    asm volatile(NWT_WGMMA_SS : NWT_ACC32("=f") : "l"(da), "l"(db), "n"(0));
}

// O += P V: D (64 x 64 f32) += A (64 x 16 bf16, registers) B (16 x 64
// bf16, shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : NWT_ACC32("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// the same with N = 32 (dh = 32)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : NWT_ACC16("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

// named barrier ID over one warpgroup (bar 0 is __syncthreads); an
// immediate id, so ptxas reserves no more barriers than the kernel uses
template <int ID>
__device__ __forceinline__ void warpgroup_sync() {
  asm volatile("bar.sync %0, 128;\n" ::"n"(ID) : "memory");
}

// exp(x) as 2^(x log2 e): one multiply and the SFU's ex2.approx.ftz
// (relative error ~2^-22, plus the product's rounding: ~1e-6 at |x| = 20,
// far under the bf16 rounding of p that follows; flushes p < 2^-126)
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// ---------------------------------------------------------------------------
// bf16 attention: TMA ring + wgmma, two passes (source note above)
// ---------------------------------------------------------------------------

constexpr int BQ = 2 * AQ;         // query rows per block: two warpgroups
constexpr int NSTAGE = 4;          // ring stages
constexpr int ATTN_THREADS = 384;  // 2 consumer warpgroups + 1 producer
// registers a thread: 168 at launch (384 threads, 3 warps per SM
// sub-partition), then the producer gives its share to the consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// one K or V tile of 64 keys at head width DH, as the TMA leaves it
template <int DH>
struct KVTile {
  static constexpr int BOX = DH < 64 ? DH : 64;        // columns per box
  static constexpr int NBOX = DH / BOX;                 // boxes side by side
  static constexpr int ROW = BOX * 2;                  // bytes per box row
  static constexpr int BOX_BYTES = AK * ROW;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr uint32_t SWIZZLE = ROW == 128 ? 1 : 2;   // descriptor
  static constexpr uint32_t SBO = 8 * ROW;             // 8-row group step
  // ring, one q tile (the same layout) per consumer warpgroup, and 1 KB to
  // align them (SWIZZLE_128B needs 1024-byte boxes)
  static constexpr int SMEM = (NSTAGE * 2 + 2) * BYTES + 1024;
};

template <int DH, typename OutT>
__global__ void __launch_bounds__(ATTN_THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const AttnArgs p) {
  using L = KVTile<DH>;
  constexpr int NO = DH < 64 ? 16 : 32;   // accumulators per 64-column box
  extern __shared__ uint8_t attn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * NSTAGE];   // full, then empty
  const uint32_t ring = (smem_u32(attn_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * NSTAGE;

  const int n_real = p.n_real, n_tiles = (n_real + AK - 1) / AK;
  const int q0 = blockIdx.x * BQ;
  const int n_wg = min(2, (p.T - q0) / AQ);
  const long long off = blockIdx.z * p.sb + blockIdx.y * p.sh;
  const int row0 = (int)(off / p.st), col0 = (int)(off % p.st);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, n_wg);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {   // producer: one thread walks both passes' loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 2 * 128) {
      for (int it = 0; it < 2 * n_tiles; ++it) {
        const int s = it % NSTAGE;
        const bool pv = it >= n_tiles;
        const int key = (pv ? it - n_tiles : it) * AK;
        if (it >= NSTAGE) mbar_wait(empty + 8 * s, ((it / NSTAGE) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, (pv ? 2 : 1) * L::BYTES);
        const uint32_t kd = ring + s * 2 * L::BYTES;
#pragma unroll
        for (int b = 0; b < L::NBOX; ++b) {
          tma_load(kd + b * L::BOX_BYTES, &tk, col0 + b * L::BOX, row0 + key,
                   full + 8 * s);
          if (pv)
            tma_load(kd + L::BYTES + b * L::BOX_BYTES, &tv, col0 + b * L::BOX,
                     row0 + key, full + 8 * s);
        }
      }
    }
    return;
  }
  if (wg >= n_wg) return;   // T % 128 == 64: the last block's second half
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wg * AQ + warp * 16 + g, r1 = r0 + 8;

  // q of the warpgroup's 64 rows, scaled on the way in (bf16(f32(q) *
  // scale)), stored as a K tile lies: the A operand of QK^T, swizzled as
  // the TMA swizzles K (16-byte chunk c of row r at c ^ (r % 8) under
  // 128-byte rows, c ^ (r / 2 % 4) under 64-byte rows)
  const uint32_t qs = ring + (NSTAGE * 2 + wg) * L::BYTES;
  {
    constexpr int CPR = DH / 8;                 // 16-byte chunks a row
    const int tid = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < AQ * CPR / 128; ++i) {
      const int ch = tid + i * 128, r = ch / CPR, c = ch % CPR;
      const int4 raw = *reinterpret_cast<const int4*>(
          p.q + off + (long long)(q0 + wg * AQ + r) * p.st + c * 8);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      const int cb = c % (L::BOX / 8);
      const int sw = L::ROW == 128 ? (r & 7) : ((r >> 1) & 3);
      const uint32_t dst = qs + (c / (L::BOX / 8)) * L::BOX_BYTES + r * L::ROW +
                           ((cb ^ sw) << 4);
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
        v[e] = pack_bf16(__fmul_rn(__low2float(h), p.q_scale),
                         __fmul_rn(__high2float(h), p.q_scale));
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
    }
    // the stores, made by the threads, are read by wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (wg == 0)
      warpgroup_sync<1>();
    else
      warpgroup_sync<2>();
  }

  // S = Q K^T of ring load `it` (its stage's K tile) as one wgmma group;
  // the first 16-deep step writes S fresh
  auto issue_s = [&](float (&s)[32], int it) {
    mbar_wait(full + 8 * (it % NSTAGE), (it / NSTAGE) & 1);
    const uint32_t kd = ring + (it % NSTAGE) * 2 * L::BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t at = (kk / 4) * L::BOX_BYTES + (kk % 4) * 32;
      const uint64_t da = smem_desc(qs + at, L::SBO, L::SWIZZLE);
      const uint64_t db = smem_desc(kd + at, L::SBO, L::SWIZZLE);
      if (kk == 0)
        wgmma_ss_n64<0>(s, da, db);
      else
        wgmma_ss_n64<1>(s, da, db);
    }
    wgmma_commit();
  };
  // one arrival per warpgroup frees ring load `it`'s stage
  auto release = [&](int it) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * (it % NSTAGE));
  };
  // keys >= n_real at -1e30; selects, no branches: a branch that defines
  // accumulator registers while a wgmma is in flight serializes them
  auto mask = [&](float (&s)[32], int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = kt * AK + j * 8 + t * 2 + (e & 1) >= n_real
                           ? -1e30f : s[4 * j + e];
  };

  // pass 1: row max, two tiles at a time (the second's scores are computed
  // while the first's max is taken); the last tile alone, masked. Every
  // group is retired before a loop's back edge.
  float sa[32], sb[32];
  float m0 = -3.0e38f, m1 = -3.0e38f;
  auto tile_max = [&](float (&s)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
      m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  };
  int kt = 0;
  for (; kt + 2 < n_tiles; kt += 2) {
    issue_s(sa, kt);
    issue_s(sb, kt + 1);
    wgmma_wait<1>();
    fence_regs(sa);
    release(kt);
    tile_max(sa);
    wgmma_wait<0>();
    fence_regs(sb);
    release(kt + 1);
    tile_max(sb);
  }
  for (; kt < n_tiles; ++kt) {
    issue_s(sa, kt);
    wgmma_wait<0>();
    fence_regs(sa);
    release(kt);
    if (kt == n_tiles - 1) mask(sa, kt);
    tile_max(sa);
  }
#pragma unroll
  for (int off2 = 1; off2 <= 2; off2 <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off2));
  }

  // pass 2: p = exp(s - m), l += p, O += bf16(p) V, in FA3's order: the
  // scores of tile kt and the PV product of tile kt - 1 are issued
  // together, and tile kt's exp runs while the tensor cores finish that
  // product. O starts at zero while no wgmma is in flight; every PV
  // product then accumulates into it in place.
  float o[DH / 64 + (DH < 64)][NO];
#pragma unroll
  for (int b = 0; b < DH / 64 + (DH < 64); ++b) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[b][i] = 0.f;
    fence_regs(o[b]);
  }
  uint32_t pa[4][4];                 // A fragments of bf16(p), 16 keys each
  float l0 = 0.f, l1 = 0.f;
  const int it0 = n_tiles;           // pass 2's first ring load
  auto issue_pv = [&](int it) {
    const uint32_t vd = ring + (it % NSTAGE) * 2 * L::BYTES + L::BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int b = 0; b < L::NBOX; ++b) {
        const uint64_t desc = smem_desc(
            vd + b * L::BOX_BYTES + kk * 16 * L::ROW, L::SBO, L::SWIZZLE);
        if constexpr (DH < 64)
          wgmma_rs_n32(o[b], pa[kk], desc);
        else
          wgmma_rs_n64(o[b], pa[kk], desc);
      }
    wgmma_commit();
  };
  auto softmax = [&]() {             // in place on sa
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sa[4 * j] = exp_sfu(__fsub_rn(sa[4 * j], m0));
      sa[4 * j + 1] = exp_sfu(__fsub_rn(sa[4 * j + 1], m0));
      sa[4 * j + 2] = exp_sfu(__fsub_rn(sa[4 * j + 2], m1));
      sa[4 * j + 3] = exp_sfu(__fsub_rn(sa[4 * j + 3], m1));
      l0 += sa[4 * j] + sa[4 * j + 1];
      l1 += sa[4 * j + 2] + sa[4 * j + 3];
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(sa[8 * kk], sa[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sa[8 * kk + 2], sa[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sa[8 * kk + 4], sa[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sa[8 * kk + 6], sa[8 * kk + 7]);
    }
  };
  // S of tile kt with the PV product of tile kt - 1; the last tile masked
  auto step = [&](int kt, auto last) {
    issue_s(sa, it0 + kt);
    issue_pv(it0 + kt - 1);
    wgmma_wait<1>();
    fence_regs(sa);
    if constexpr (decltype(last)::value) mask(sa, kt);
    softmax();
    wgmma_wait<0>();
    fence_regs(sa);
    release(it0 + kt - 1);
    pack();
  };
  issue_s(sa, it0);
  wgmma_wait<0>();
  fence_regs(sa);
  if (n_tiles == 1) mask(sa, 0);
  softmax();
  pack();
  for (kt = 1; kt + 1 < n_tiles; ++kt) step(kt, Flag<false>{});
  if (n_tiles > 1) step(n_tiles - 1, Flag<true>{});
  issue_pv(it0 + n_tiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < DH / 64 + (DH < 64); ++b) fence_regs(o[b]);
#pragma unroll
  for (int off2 = 1; off2 <= 2; off2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off2);
  }

  OutT* O = static_cast<OutT*>(p.o) + off;
#pragma unroll
  for (int b = 0; b < DH / 64 + (DH < 64); ++b)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = b * 64 + j * 8 + t * 2;
      const float v00 = __fdiv_rn(o[b][4 * j], l0);
      const float v01 = __fdiv_rn(o[b][4 * j + 1], l0);
      const float v10 = __fdiv_rn(o[b][4 * j + 2], l1);
      const float v11 = __fdiv_rn(o[b][4 * j + 3], l1);
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float2*>(O + r0 * p.st + c) = make_float2(v00, v01);
        *reinterpret_cast<float2*>(O + r1 * p.st + c) = make_float2(v10, v11);
      } else {
        *reinterpret_cast<uint32_t*>(O + r0 * p.st + c) = pack_bf16(v00, v01);
        *reinterpret_cast<uint32_t*>(O + r1 * p.st + c) = pack_bf16(v10, v11);
      }
    }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// K or V as a (rows, cols) bf16 matrix of row pitch cols, in boxes of 64
// rows by min(dh, 64) columns
template <int DH>
inline bool kv_tensor_map(CUtensorMap* map, const bf16* z, long long rows,
                          long long cols) {
  using L = KVTile<DH>;
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)L::BOX, (cuuint32_t)AK};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<bf16*>(z), dims, pitch, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// grid (ceil(T / 128), H, B); a.sb, a.sh, a.st as AttnArgs says
template <int DH, typename OutT>
inline cudaError_t launch_attn_wgmma(AttnArgs a, int B, int H, int T,
                                     cudaStream_t st) {
  using L = KVTile<DH>;
  a.T = T;
  a.H = H;
  CUtensorMap tk, tv;
  const long long rows = (long long)B * a.sb / a.st;
  if (!kv_tensor_map<DH>(&tk, a.k, rows, a.st) ||
      !kv_tensor_map<DH>(&tv, a.v, rows, a.st))
    return cudaErrorInvalidValue;
  // at every launch: a static flag here would be one symbol for every
  // library that includes this file (K12's too), each with its own kernel
  cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<DH, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  attn_wgmma_kernel<DH, OutT>
      <<<dim3((T + BQ - 1) / BQ, H, B), ATTN_THREADS, L::SMEM, st>>>(tk, tv,
                                                                     a);
  return cudaGetLastError();
}

// K3 and K9: the head widths the kernel is built for
inline cudaError_t launch_attn(const AttnArgs& a, int dh, int T, int H, int B,
                               cudaStream_t st) {
  switch (dh) {
    case 32: return launch_attn_wgmma<32, bf16>(a, B, H, T, st);
    case 64: return launch_attn_wgmma<64, bf16>(a, B, H, T, st);
    case 128: return launch_attn_wgmma<128, bf16>(a, B, H, T, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// int8 variants (mma.sync): one (batch row, head) per blockIdx.(z, y), 64
// query rows per block of 4 warps, heads of 64
// ---------------------------------------------------------------------------

// four non-negative int8 values (0..127), the lowest first
__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) |
         ((uint32_t)d << 24);
}

// a head's int8 scale from its absmax bits: max(absmax, 1e-6) / 127
__device__ __forceinline__ float head_scale(unsigned bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(bits), 1e-6f), 127.0f);
}

// Position of key j (0..63 of a tile) in the int8 PV operand's k order:
// inside each 32-key step, slot 4 t + i of the A fragment (thread t of a
// quad) holds the probability the scores' accumulator gives that thread:
// keys 2 t, 2 t + 1 of 8-key groups 0 and 1 (slots 0..15), of groups 2
// and 3 (slots 16..31).
__device__ __forceinline__ int key_slot(int j) {
  const int w = j & 31, half = w >> 4, grp = (w >> 3) & 1, r = w & 7;
  return (j & ~31) + half * 16 + (r >> 1) * 4 + grp * 2 + (r & 1);
}

// S (16 x 64 keys) of this warp's query rows against the bf16 key tile Ks
// ([key][DH + 8] row-major), keys >= n_real set to -1e30 (int8 PV alone).
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

// The same with int8 q (dh = 64) against the int8 key tile Ks8 ([key][KLD8]):
// s = f32(int32 dot) * f, f = sq * (sk * scale) of the row (f0: row g,
// f1: row g + 8).
__device__ __forceinline__ void scores_tile_s8(const int8_t* Ks8,
                                               const uint32_t (&qa)[2][4],
                                               int key0, int n_real, float f0,
                                               float f1, float (&s)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int c[4] = {0, 0, 0, 0};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int8_t* kr = Ks8 + (j * 8 + g) * KLD8 + kk * 32 + t * 4;
      mma_s8(c, qa[kk], *reinterpret_cast<const uint32_t*>(kr),
             *reinterpret_cast<const uint32_t*>(kr + 16));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __fmul_rn(__int2float_rn(c[e]), e < 2 ? f0 : f1);
      if (key0 + j * 8 + t * 2 + (e & 1) >= n_real) s[j][e] = -1e30f;
    }
  }
}

template <bool I8S, bool I8PV, typename OutT>
__global__ void __launch_bounds__(128) attn_i8_kernel(AttnArgs p) {
  static_assert(I8S || I8PV, "bf16 scores and PV: attn_wgmma_kernel");
  constexpr int DH = 64;
  constexpr int LD = DH + 8;          // padded Ks row: no bank conflicts
  constexpr int CHUNKS = AK * DH / 8; // 16-byte chunks of one bf16 K or V tile
  constexpr int KS_BYTES = I8S ? AK * KLD8 : AK * LD * 2;
  constexpr int VS_BYTES = I8PV ? DH * KLD8 : DH * VLD * 2;
  __shared__ __align__(16) unsigned char ks_raw[KS_BYTES];
  __shared__ __align__(16) unsigned char vs_raw[VS_BYTES];
  bf16 (*Ks)[LD] = reinterpret_cast<bf16 (*)[LD]>(ks_raw);
  bf16 (*Vt)[VLD] = reinterpret_cast<bf16 (*)[VLD]>(vs_raw);    // [dh][key]
  int8_t (*Ks8)[KLD8] = reinterpret_cast<int8_t (*)[KLD8]>(ks_raw);
  int8_t (*Vt8)[KLD8] = reinterpret_cast<int8_t (*)[KLD8]>(vs_raw);  // [dh][slot]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long base = blockIdx.z * p.sb + blockIdx.y * p.sh;
  const int r0 = blockIdx.x * AQ + warp * 16 + g, r1 = r0 + 8;
  const int bh = blockIdx.z * p.H + blockIdx.y;

  uint32_t qa[DH / 16][4];           // bf16 q fragments
  uint32_t qa8[2][4];                // int8 q fragments (I8S)
  float f0 = 0.f, f1 = 0.f;          // per-row score factors (I8S)
  if constexpr (I8S) {
    const int8_t* Q = p.qq + base;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int8_t* q0 = Q + r0 * p.st + kk * 32 + t * 4;
      const int8_t* q1 = Q + r1 * p.st + kk * 32 + t * 4;
      qa8[kk][0] = *reinterpret_cast<const uint32_t*>(q0);
      qa8[kk][1] = *reinterpret_cast<const uint32_t*>(q1);
      qa8[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 16);
      qa8[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + 16);
    }
    const float ks = __fmul_rn(head_scale(p.kamax[bh]), p.q_scale);
    const size_t row0 = ((size_t)blockIdx.z * p.T + r0) * p.H + blockIdx.y;
    f0 = __fmul_rn(p.qs[row0], ks);
    f1 = __fmul_rn(p.qs[row0 + (size_t)8 * p.H], ks);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const bf16* q0 = p.q + base + r0 * p.st + kk * 16 + t * 2;
      const bf16* q1 = p.q + base + r1 * p.st + kk * 16 + t * 2;
      qa[kk][0] = load_q2(q0, p.q_scale);
      qa[kk][1] = load_q2(q1, p.q_scale);
      qa[kk][2] = load_q2(q0 + 8, p.q_scale);
      qa[kk][3] = load_q2(q1 + 8, p.q_scale);
    }
  }

  const int n_real = p.n_real;
  const int n_tiles = (n_real + AK - 1) / AK;

  auto load_k = [&](int kt) {
    if constexpr (I8S) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {              // 256 chunks of 16 B
        const int c = threadIdx.x + i * 128;
        const int kr = c >> 2, dc = (c & 3) * 16;
        *reinterpret_cast<int4*>(&Ks8[kr][dc]) =
            *reinterpret_cast<const int4*>(p.kq + base + (kt * AK + kr) * p.st + dc);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CHUNKS / 128; ++i) {
        const int c = threadIdx.x + i * 128;
        const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
        *reinterpret_cast<int4*>(&Ks[kr][dc]) = *reinterpret_cast<const int4*>(
            p.k + base + (kt * AK + kr) * p.st + dc);
      }
    }
  };
  auto scores = [&](int kt, float (&s)[8][4]) {
    if constexpr (I8S)
      scores_tile_s8(&Ks8[0][0], qa8, kt * AK, n_real, f0, f1, s);
    else
      scores_tile<DH>(&Ks[0][0], qa, kt * AK, n_real, s);
  };

  // pass 1: row max
  float m0 = -3.0e38f, m1 = -3.0e38f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    load_k(kt);
    __syncthreads();
    float s[8][4];
    scores(kt, s);
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

  // pass 2: p = exp(s - max); bf16: sum p, o += bf16(p) @ v;
  // int8: pq = rint(p * 127), sum pq, o += pq @ vq
  float l0 = 0.f, l1 = 0.f;
  int lq0 = 0, lq1 = 0;
  float o[DH / 8][4];
  int oi[DH / 8][4];
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[j][e] = 0.f;
      oi[j][e] = 0;
    }
  for (int kt = 0; kt < n_tiles; ++kt) {
    load_k(kt);
    if constexpr (I8PV) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {              // 256 chunks of 16 B
        const int c = threadIdx.x + i * 128;
        const int kr = c >> 2, dc = (c & 3) * 16;
        int4 vv = *reinterpret_cast<const int4*>(
            p.vq + base + (kt * AK + kr) * p.st + dc);
        const int8_t* pv = reinterpret_cast<const int8_t*>(&vv);
        const int slot = key_slot(kr);
#pragma unroll
        for (int e = 0; e < 16; ++e) Vt8[dc + e][slot] = pv[e];
      }
    } else {
#pragma unroll
      for (int i = 0; i < CHUNKS / 128; ++i) {
        const int c = threadIdx.x + i * 128;
        const int kr = c / (DH / 8), dc = (c % (DH / 8)) * 8;
        int4 vv = *reinterpret_cast<const int4*>(
            p.v + base + (kt * AK + kr) * p.st + dc);
        const bf16* pv = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
        for (int e = 0; e < 8; ++e) Vt[dc + e][kr] = pv[e];
      }
    }
    __syncthreads();
    float s[8][4];
    scores(kt, s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(__fsub_rn(s[j][0], m0));
      s[j][1] = expf(__fsub_rn(s[j][1], m0));
      s[j][2] = expf(__fsub_rn(s[j][2], m1));
      s[j][3] = expf(__fsub_rn(s[j][3], m1));
    }
    if constexpr (I8PV) {
      int pq[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pq[j][e] = (int)rintf(__fmul_rn(s[j][e], 127.0f));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        lq0 += pq[j][0] + pq[j][1];
        lq1 += pq[j][2] + pq[j][3];
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {         // 32 keys per step
        const int j = kk * 4;
        uint32_t pa[4];
        pa[0] = pack_s8(pq[j][0], pq[j][1], pq[j + 1][0], pq[j + 1][1]);
        pa[1] = pack_s8(pq[j][2], pq[j][3], pq[j + 1][2], pq[j + 1][3]);
        pa[2] = pack_s8(pq[j + 2][0], pq[j + 2][1], pq[j + 3][0], pq[j + 3][1]);
        pa[3] = pack_s8(pq[j + 2][2], pq[j + 2][3], pq[j + 3][2], pq[j + 3][3]);
#pragma unroll
        for (int jd = 0; jd < DH / 8; ++jd) {
          const int8_t* vr = &Vt8[jd * 8 + g][kk * 32 + t * 4];
          mma_s8(oi[jd], pa, *reinterpret_cast<const uint32_t*>(vr),
                 *reinterpret_cast<const uint32_t*>(vr + 16));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
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
    }
    __syncthreads();
  }
  float sv = 1.f;
  if constexpr (I8PV) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      lq0 += __shfl_xor_sync(0xffffffffu, lq0, off);
      lq1 += __shfl_xor_sync(0xffffffffu, lq1, off);
    }
    // sum pq <= 127 T < 2^24: exact in f32, as the reference's f32 sum
    l0 = fmaxf((float)lq0, 1.0f);
    l1 = fmaxf((float)lq1, 1.0f);
    sv = head_scale(p.vamax[bh]);
#pragma unroll
    for (int jd = 0; jd < DH / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] = __int2float_rn(oi[jd][e]);
  } else {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }

  OutT* O = static_cast<OutT*>(p.o) + base;
#pragma unroll
  for (int jd = 0; jd < DH / 8; ++jd) {
    const int c = jd * 8 + t * 2;
    float v00 = __fdiv_rn(o[jd][0], l0), v01 = __fdiv_rn(o[jd][1], l0);
    float v10 = __fdiv_rn(o[jd][2], l1), v11 = __fdiv_rn(o[jd][3], l1);
    if constexpr (I8PV) {
      v00 = __fmul_rn(v00, sv);
      v01 = __fmul_rn(v01, sv);
      v10 = __fmul_rn(v10, sv);
      v11 = __fmul_rn(v11, sv);
    }
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(O + r0 * p.st + c) = make_float2(v00, v01);
      *reinterpret_cast<float2*>(O + r1 * p.st + c) = make_float2(v10, v11);
    } else {
      *reinterpret_cast<uint32_t*>(O + r0 * p.st + c) = pack_bf16(v00, v01);
      *reinterpret_cast<uint32_t*>(O + r1 * p.st + c) = pack_bf16(v10, v11);
    }
  }
}

// the flat path at dh = 64 (K1, K1-o, K3's int8 entry): int8 scores and PV
// (flags) on attn_i8_kernel, bf16 on attn_wgmma_kernel; output in f32 for
// the fused o projection
template <typename OutT>
inline cudaError_t launch_attn_flat(const AttnArgs& a, int flags, int T,
                                    int H, int B, cudaStream_t st) {
  const dim3 grid(T / AQ, H, B);
  switch (flags & (I8_SCORES | I8_PV)) {
    case 0: return launch_attn_wgmma<64, OutT>(a, B, H, T, st);
    case I8_SCORES: attn_i8_kernel<true, false, OutT><<<grid, 128, 0, st>>>(a); break;
    case I8_PV: attn_i8_kernel<false, true, OutT><<<grid, 128, 0, st>>>(a); break;
    default: attn_i8_kernel<true, true, OutT><<<grid, 128, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 variants' preparation
// ---------------------------------------------------------------------------

// q (M = B T rows, H heads of 64) -> qq = clip(rint(q / sq)), sq = max(absmax
// of the row's head, 1e-6) / 127 at qs[row H + h]. One warp per (row, head).
template <typename TQ>
__global__ void __launch_bounds__(256)
quant_q_kernel(const TQ* __restrict__ q, int8_t* __restrict__ qq,
               float* __restrict__ qs, long long n_heads, int H) {
  const long long w = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (w >= n_heads) return;
  const int lane = threadIdx.x & 31;
  const long long off = w * 64 + lane * 2;   // (row, head) w is 64 contiguous
  const float a = to_f32(q[off]), b = to_f32(q[off + 1]);
  const float s = __fdiv_rn(fmaxf(warp_max(fmaxf(fabsf(a), fabsf(b))), 1e-6f),
                            127.0f);
  qq[off] = quant_s8(a, s);
  qq[off + 1] = quant_s8(b, s);
  if (lane == 0) qs[w] = s;
}

// per (batch row, head) absmax of z (k: blockIdx.z 0, v: 1; a null tensor
// is skipped) over rows < n_real, as float bits by atomicMax; grid
// (ceil(n_real / 32), B, 2), 256 threads over the d columns
__global__ void __launch_bounds__(256)
head_absmax_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   unsigned* __restrict__ amax, int T, int d, int n_real) {
  const bf16* z = blockIdx.z ? v : k;
  if (!z) return;
  const int H = d / 64, b = blockIdx.y;
  const int r_lo = blockIdx.x * 32, r_hi = min(r_lo + 32, n_real);
  unsigned* out = amax + ((size_t)blockIdx.z * gridDim.y + b) * H;
  for (int c = threadIdx.x; c < d; c += 256) {   // a warp: 32 columns, 1 head
    float m = 0.f;
    for (int r = r_lo; r < r_hi; ++r)
      m = fmaxf(m, fabsf(__bfloat162float(z[((size_t)b * T + r) * d + c])));
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) atomicMax(out + c / 64, __float_as_uint(m));
  }
}

// kq / vq = clip(rint(z * (1 / s))), s the head's scale; 8 values a thread;
// grid (ceil(B T d / 2048), 2): y 0 = k, 1 = v (null skipped)
__global__ void __launch_bounds__(256)
quant_kv_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                const unsigned* __restrict__ amax, int B, int T, int d) {
  const bf16* z = blockIdx.y ? v : k;
  int8_t* zq = blockIdx.y ? vq : kq;
  if (!z) return;
  const size_t i = ((size_t)blockIdx.x * 256 + threadIdx.x) * 8;
  if (i >= (size_t)B * T * d) return;
  const int H = d / 64;
  const int b = (int)(i / ((size_t)T * d)), h = (int)(i % d) / 64;
  const float inv = __fdiv_rn(
      1.0f, head_scale(amax[((size_t)blockIdx.y * B + b) * H + h]));
  int4 raw = *reinterpret_cast<const int4*>(z + i);
  const bf16* zv = reinterpret_cast<const bf16*>(&raw);
  uint32_t w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = rintf(__fmul_rn(__bfloat162float(zv[4 * e + j]), inv));
      r[j] = (int)fminf(fmaxf(x, -127.0f), 127.0f);
    }
    w[e] = (uint32_t)(uint8_t)r[0] | ((uint32_t)(uint8_t)r[1] << 8) |
           ((uint32_t)(uint8_t)r[2] << 16) | ((uint32_t)(uint8_t)r[3] << 24);
  }
  *reinterpret_cast<uint2*>(zq + i) = make_uint2(w[0], w[1]);
}

// q (B, T, d) in TQ (K1: f32 unscaled; K3: bf16), k, v (B, T, d) bf16;
// d = 64 H. Writes what the flags ask for: qq, qs (int8 scores), kq (int8
// scores), vq (int8 PV); amax: (2, B, H) u32 scratch.
template <typename TQ>
inline cudaError_t int8_prep(const TQ* q, const bf16* k, const bf16* v,
                             int flags, int8_t* qq, float* qs, int8_t* kq,
                             int8_t* vq, unsigned* amax, int B, int T, int d,
                             int n_real, cudaStream_t st) {
  const int H = d / 64;
  const bool s8 = flags & I8_SCORES, pv = flags & I8_PV;
  cudaError_t e = cudaMemsetAsync(amax, 0, (size_t)2 * B * H * sizeof(unsigned), st);
  if (e != cudaSuccess) return e;
  if (s8) {
    const long long n = (long long)B * T * H;
    quant_q_kernel<TQ><<<(unsigned)((n + 7) / 8), 256, 0, st>>>(q, qq, qs, n, H);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const bf16* kk = s8 ? k : nullptr;
  const bf16* vv = pv ? v : nullptr;
  head_absmax_kernel<<<dim3((n_real + 31) / 32, B, 2), 256, 0, st>>>(
      kk, vv, amax, T, d, n_real);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n8 = (size_t)B * T * d / 8;
  quant_kv_kernel<<<dim3((unsigned)((n8 + 255) / 256), 2), 256, 0, st>>>(
      kk, vv, kq, vq, amax, B, T, d);
  return cudaGetLastError();
}

// K1, every variant. x (B, T, d) bf16 with T % 64 == 0, d % 128 == 0,
// d == 64 * n_head; weights (d, d) int8 row-major (d_in, d_out) with (d,)
// f32 column scales; ln_g, ln_b, bq, bv, bo (d,) f32. Workspace: xq (B*T, d)
// int8, sx (B*T,) f32, q (B, T, d) bf16 (f32 with I8_SCORES), k, v (B, T, d)
// bf16; with FUSE_O a32 (B*T, d) f32, aq (B*T, d) int8, sa (B*T, d / 128)
// f32; with the int8 flags qq, qs, kq, vq, amax as int8_prep says. Writes
// out (B, T, d) bf16: the attention, or with FUSE_O x + attention @ wo + bo.
inline cudaError_t encoder_attention_fused_qkv(
    const void* x, const void* ln_g, const void* ln_b,
    const void* wq, const void* sq, const void* bq,
    const void* wk, const void* sk,
    const void* wv, const void* sv, const void* bv,
    const void* wo, const void* so, const void* bo,
    void* out, void* xq, void* sx, void* q, void* k, void* v,
    void* a32, void* aq, void* sa,
    void* qq, void* qs, void* kq, void* vq, void* amax,
    int B, int T, int d, int n_real, float sm_scale, int flags,
    cudaStream_t st) {
  const int M = B * T, H = d / 64;
  const bool s8 = flags & I8_SCORES, fuse_o = flags & FUSE_O;
  cudaError_t e = launch_ln_quant(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_g),
      static_cast<const float*>(ln_b), static_cast<int8_t*>(xq),
      static_cast<float*>(sx), M, d, st);
  if (e != cudaSuccess) return e;

  e = launch_qkv_gemm<bf16>(xq, sx, wq, sq, bq, wk, sk, wv, sv, bv, q, k, v,
                            sm_scale, M, d, st,
                            s8 ? static_cast<float*>(q) : nullptr);
  if (e != cudaSuccess) return e;
  if (flags & (I8_SCORES | I8_PV)) {
    e = int8_prep<float>(static_cast<const float*>(q),
                         static_cast<const bf16*>(k),
                         static_cast<const bf16*>(v), flags,
                         static_cast<int8_t*>(qq), static_cast<float*>(qs),
                         static_cast<int8_t*>(kq), static_cast<int8_t*>(vq),
                         static_cast<unsigned*>(amax), B, T, d, n_real, st);
    if (e != cudaSuccess) return e;
  }

  const unsigned* am = static_cast<const unsigned*>(amax);
  AttnArgs at{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
              static_cast<const bf16*>(v), fuse_o ? a32 : out,
              (long long)T * d, 64, d, n_real,
              s8 ? sm_scale : 1.0f,       // q is scaled already otherwise
              static_cast<const int8_t*>(qq), static_cast<const float*>(qs),
              static_cast<const int8_t*>(kq), static_cast<const int8_t*>(vq),
              am, am + (size_t)B * H, T, H};
  if (!fuse_o) return launch_attn_flat<bf16>(at, flags, T, H, B, st);
  e = launch_attn_flat<float>(at, flags, T, H, B, st);
  if (e != cudaSuccess) return e;

  // o projection: per-(row, head pair) quantization of the f32 attention
  // output (rows of 128), then x + bo + the pair slices' products in order
  e = launch_ln_quant<float, false>(static_cast<const float*>(a32), nullptr,
                                    nullptr, static_cast<int8_t*>(aq),
                                    static_cast<float*>(sa), M * (d / 128),
                                    128, st);
  if (e != cudaSuccess) return e;
  FC2Args<bf16> f;
  f.aq = static_cast<const int8_t*>(aq);
  f.amax = nullptr;
  f.sa = static_cast<const float*>(sa);
  f.w2 = static_cast<const int8_t*>(wo);
  f.s2 = static_cast<const float*>(so);
  f.b2 = static_cast<const float*>(bo);
  f.x = static_cast<const bf16*>(x);
  f.out = static_cast<bf16*>(out);
  f.M = M;
  f.d = d;
  f.F = d;
  f.block_f = 128;
  return launch_fc2_gemm(f, st);
}

}  // namespace nwt

using namespace nwt;

#define NWT_K1_ARGS                                                        \
  const void *x, const void *ln_g, const void *ln_b, const void *wq,      \
      const void *sq, const void *bq, const void *wk, const void *sk,     \
      const void *wv, const void *sv, const void *bv, const void *wo,     \
      const void *so, const void *bo, void *out, void *xq, void *sx,      \
      void *q, void *k, void *v, void *a32, void *aq, void *sa, void *qq, \
      void *qs, void *kq, void *vq, void *amax
#define NWT_K1_PASS                                                       \
  x, ln_g, ln_b, wq, sq, bq, wk, sk, wv, sv, bv, wo, so, bo, out, xq, sx, \
      q, k, v, a32, aq, sa, qq, qs, kq, vq, amax

// K1: see encoder_attention_fused_qkv above; flags: 1 int8 scores, 2 int8
// PV, 4 the o projection and residual fused (wo, so, bo, a32, aq, sa).
extern "C" int nwt_encoder_attention_fused_qkv(NWT_K1_ARGS, int B, int T,
                                               int d, int n_real,
                                               float sm_scale, int flags,
                                               void* stream) {
  return (int)encoder_attention_fused_qkv(
      NWT_K1_PASS, B, T, d, n_real, sm_scale, flags,
      reinterpret_cast<cudaStream_t>(stream));
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

// K3's int8 variants (flags 1: int8 scores, 2: int8 PV; dh = 64): q, k, v,
// out (B, T, d) bf16, d = 64 H; workspace qq, qs, kq, vq, amax as int8_prep
// says.
extern "C" int nwt_encoder_attention_btd_int8(
    const void* q, const void* k, const void* v, void* out, void* qq,
    void* qs, void* kq, void* vq, void* amax, int B, int T, int H,
    int n_real, float sm_scale, int flags, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int d = 64 * H;
  cudaError_t e = int8_prep<bf16>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), flags, static_cast<int8_t*>(qq),
      static_cast<float*>(qs), static_cast<int8_t*>(kq),
      static_cast<int8_t*>(vq), static_cast<unsigned*>(amax), B, T, d,
      n_real, st);
  if (e != cudaSuccess) return (int)e;
  const unsigned* am = static_cast<const unsigned*>(amax);
  AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
             static_cast<const bf16*>(v), out, (long long)T * d, 64, d,
             n_real, sm_scale, static_cast<const int8_t*>(qq),
             static_cast<const float*>(qs), static_cast<const int8_t*>(kq),
             static_cast<const int8_t*>(vq), am, am + (size_t)B * H, T, H};
  return (int)launch_attn_flat<bf16>(a, flags, T, H, B, st);
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
