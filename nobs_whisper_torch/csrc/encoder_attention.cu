// Encoder self-attention: non-causal softmax attention per head, keys >=
// n_real masked. Three entry points share one attention kernel for Hopper
// (attn_wgmma_kernel), templated on the head width, the output type and the
// two opt-in int8 variants:
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
// attn_wgmma_kernel (sm_90a), every launch of K1, K3, K9 and K12:
//   * Grid (ceil(T / 128), H, B), 384 threads: two consumer warpgroups of
//     64 query rows (warps 0-3 and 4-7) and a producer warpgroup (one
//     thread issues every load), so each staged K/V tile serves 128 query
//     rows. setmaxnreg moves registers from the producer (40) to the
//     consumers (232): 384 threads leave 168 a thread, too few for dh =
//     128's O (64 f32) beside an S tile in flight. Where T % 128 == 64 the
//     last block's second warpgroup has no rows and leaves at once; the
//     ring's "empty" barriers count the warpgroups that stay.
//   * Layouts: K and V of every head are rows of one 2-D matrix whose row
//     pitch is its width: the flat (B T, d) layout with head h at column
//     h dh, or the per-head (B H T, dh) one. The C entry point builds one
//     tensor map each for K and V (cuTensorMapEncodeTiled, fetched with
//     cudaGetDriverEntryPoint, so nothing links libcuda) and passes them as
//     __grid_constant__ parameters. A box is 64 rows by at most 128 bytes
//     (Tile): 128-byte rows under SWIZZLE_128B (bf16 dh = 64; dh = 128
//     loads two boxes side by side), 64-byte rows under SWIZZLE_64B (bf16
//     dh = 32, and every int8 operand).
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
//     k-step of each QK^T writes S as an output only, O is zeroed while
//     nothing is in flight and then only accumulated, every loop retires
//     its groups before its back edge, and the key mask is selects on the
//     peeled last tile.
//   * p = exp(s - m) on the SFU: ex2.approx.ftz of (s - m) log2 e, within
//     ~1e-6 of the accurate expf (the plain version's torch.exp) and far
//     under the bf16 rounding of p that follows (chip_smoke.py and the
//     on-card tests hold every shape to one bf16 step of the plain
//     version); keys >= n_real at -1e30 in the last tile; l is summed in
//     f32 from the unrounded p; o / l leaves from registers as bf16, or f32
//     (OutT) for K1 with the o projection fused and for K12. Padded query
//     rows see real keys only, so their output is finite.
//   * The int8 variants (NWT_ATTN_I8, NWT_ATTN_I8PV; the flat path, dh =
//     64) are instantiations of the same kernel (I8S, I8PV):
//     - int8 scores: QK^T is wgmma.m64n64k32.s32.s8.s8, two k-steps over
//       dh = 64, A = the block's int8 q rows (staged as the bf16 q is, in
//       64-byte rows), B = the int8 K tile as the TMA loads it from the
//       flat (B T, d) int8 matrix. The int32 dot is exact; then s =
//       f32(dot) * (sq * (sk * scale)) of the row, each product rounded.
//     - int8 PV: pq = rint(p * 127) as int8, O_int += pq vq on
//       wgmma.m64n64k32.s32.s8.s8 with A = pq packed from the S
//       accumulator in registers. 8-bit wgmma reads B K-major only, so vq
//       lies as (B, H, 64, T), (dh, key) per head, and int8_prep writes the
//       keys of each 32-key step in the order the S accumulator leaves
//       them (key_slot): the 8-bit A fragment of a k-step holds k = 4t ..
//       4t + 3 and 16 + 4t .. 16 + 4t + 3 in thread t of a quad (rows g
//       and g + 8), the accumulator keys 2t, 2t + 1 of each 8-key group,
//       so the packed pq is the A fragment as it lies and the kernel
//       transposes nothing. The normaliser is the integer sum of pq
//       (exact), max(sum, 1); o = (f32(O_int) / l) * sv. O_int is zeroed
//       while nothing is in flight, as O is.
//     - An int8 tile is half a bf16 tile's bytes: the int8 instantiations'
//       ring has 8 stages in the shared memory the bf16 ring's 4 take.

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
//      every real row before any score, so two launches: the first takes
//      it (exact: a max), AMAX_PARTS blocks per (batch row, head) each over
//      a range of rows, and quantizes q in its other blocks; the second quantizes k as it lies and v
//      transposed per head into (dh, key) rows in key_slot order through
//      shared memory. The TPU kernel holds a head pair's whole K and V in
//      VMEM and takes the statistic there.
//   4. K1 with the o projection (NWT_ATTN_FUSED=2): the attention writes
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
// query blocks of 256 rows are 128 here: the rows of a block share one K/V
// tile stream through shared memory.

#include "common.cuh"
#include "hopper.cuh"

#include <climits>
#include <type_traits>

namespace nwt {

constexpr int AQ = 64;      // query rows per consumer warpgroup
constexpr int AK = 64;      // keys per tile

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
  // absmax bits kamax[(b H + h) AMAX_PARTS + i], vamax likewise; qq and
  // kq in q's layout, vq (B, H, 64, T) as i8_quant_kv_kernel lays it
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

#define NWT_ACC16(C)                                                    \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), \
      C(d[15])
#define NWT_ACC32(C)                                                      \
  NWT_ACC16(C), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]),        \
      C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]),        \
      C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31])
#define NWT_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"
#define NWT_WGMMA_SS                                                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " NWT_D32            \
  ", %32, %33, p, 1, 1, 0, 0;\n}\n"
#define NWT_WGMMA_S8_SS                                                      \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                               \
  "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " NWT_D32                \
  ", %32, %33, p;\n}\n"

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

// int8 S = Q K^T: D (64 x 64 s32) = A B + (ACC ? D : 0), A (64 x 32 s8)
// and B (32 x 64 s8) both K-major in shared memory (8-bit wgmma takes no
// other layout); ACC = 0 as in wgmma_ss_n64
template <int ACC>
__device__ __forceinline__ void wgmma_s8_ss_n64(uint32_t (&d)[32], uint64_t da,
                                                uint64_t db) {
  if constexpr (ACC)
    asm volatile(NWT_WGMMA_S8_SS : NWT_ACC32("+r") : "l"(da), "l"(db), "n"(1));
  else
    asm volatile(NWT_WGMMA_S8_SS : NWT_ACC32("=r") : "l"(da), "l"(db), "n"(0));
}

// int8 O += P V: D (64 x 64 s32) += A (64 x 32 s8, registers) B (32 x 64
// s8, shared memory, K-major: vq's (dh, key) rows)
__device__ __forceinline__ void wgmma_s8_rs_n64(uint32_t (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " NWT_D32
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : NWT_ACC32("+r")
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
// The attention kernel: TMA ring + wgmma, two passes (source note above)
// ---------------------------------------------------------------------------

constexpr int BQ = 2 * AQ;         // query rows per block: two warpgroups
constexpr int ATTN_THREADS = 384;  // 2 consumer warpgroups + 1 producer
// registers a thread: 168 at launch (384 threads, 3 warps per SM
// sub-partition), then the producer gives its share to the consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// one 64-row operand tile as the TMA leaves it: rows of RB bytes (a bf16
// q/K/V row of dh: 2 dh bytes; an int8 q/K row of dh = 64 or vq row of 64
// keys: 64 bytes), in boxes of at most 128 bytes a row side by side
template <int RB>
struct Tile {
  static constexpr int ROW = RB < 128 ? RB : 128;      // bytes per box row
  static constexpr int NBOX = RB / ROW;                 // boxes side by side
  static constexpr int BOX_BYTES = AK * ROW;
  static constexpr int BYTES = NBOX * BOX_BYTES;
  static constexpr uint32_t SWIZZLE = ROW == 128 ? 1 : 2;   // descriptor
  static constexpr uint32_t SBO = 8 * ROW;             // 8-row group step
  // 16-byte chunk c of row r after the TMA's swizzle (c ^ (r % 8) under
  // 128-byte rows, c ^ (r / 2 % 4) under 64-byte rows)
  static __device__ __forceinline__ int chunk(int r, int c) {
    return c ^ (ROW == 128 ? (r & 7) : ((r >> 1) & 3));
  }
};

// one instantiation's operand tiles and ring: q and K tiles (bf16, or int8
// rows of dh = 64 bytes with I8S), V tiles (bf16 [key][dh], or int8 [dh]
// [key] with I8PV); the ring, one q tile per consumer warpgroup, and 1 KB
// to align them (SWIZZLE_128B needs 1024-byte boxes)
template <int DH, bool I8S, bool I8PV>
struct AttnCfg {
  using QK = Tile<I8S ? DH : 2 * DH>;
  using V = Tile<I8PV ? AK : 2 * DH>;
  static constexpr int NSTAGE = I8S || I8PV ? 8 : 4;
  static constexpr int STAGE = QK::BYTES + V::BYTES;
  static constexpr int SMEM = NSTAGE * STAGE + 2 * QK::BYTES + 1024;
};

// The int8 variants' per-head absmax (int8_prep) is kept as AMAX_PARTS
// maxima over row ranges, so that enough blocks read k and v at once; every
// reader takes their max (exact, in any order).
constexpr int AMAX_PARTS = 8;

// a head's int8 scale from its AMAX_PARTS absmax bits: max(absmax, 1e-6) / 127
__device__ __forceinline__ float head_scale(const unsigned* parts) {
  float m = 0.f;
#pragma unroll
  for (int i = 0; i < AMAX_PARTS; ++i) m = fmaxf(m, __uint_as_float(parts[i]));
  return __fdiv_rn(fmaxf(m, 1e-6f), 127.0f);
}

// Position of key j (0..63 of a tile) in vq's key order: inside each
// 32-key step, slot 4 t + i of the 8-bit A fragment (thread t of a quad)
// holds the probability the scores' accumulator gives that thread: keys
// 2 t, 2 t + 1 of 8-key groups 0 and 1 (slots 0..15), of groups 2 and 3
// (slots 16..31).
__device__ __forceinline__ int key_slot(int j) {
  const int w = j & 31, half = w >> 4, grp = (w >> 3) & 1, r = w & 7;
  return (j & ~31) + half * 16 + (r >> 1) * 4 + grp * 2 + (r & 1);
}

// The S accumulator holds f32 (bf16 scores) or s32 (int8 scores) bits; the
// softmax reads and writes f32 values through these, in place.
__device__ __forceinline__ float s_get(float x) { return x; }
__device__ __forceinline__ float s_get(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ void s_set(float& x, float v) { x = v; }
__device__ __forceinline__ void s_set(uint32_t& x, float v) {
  x = __float_as_uint(v);
}
__device__ __forceinline__ uint32_t s_bits(float x) { return __float_as_uint(x); }
__device__ __forceinline__ uint32_t s_bits(uint32_t x) { return x; }

// Exact integer <-> f32 on the FMA and integer pipes, for |i| < 2^22: the
// f32 1.5 2^23 + i holds i in its low mantissa bits (the conversion
// instructions would share the SFU's quarter rate with the exp). int8
// scores: f32(dot) with |dot| <= 64 127^2; int8 PV: rint(x) for x in
// [0, 127] is the low byte of x + 1.5 2^23, rounded to nearest even as
// rintf rounds.
constexpr uint32_t MAGIC_BITS = 0x4B400000u;
constexpr float MAGIC = 12582912.0f;
__device__ __forceinline__ float i2f_exact(uint32_t i) {
  return __fsub_rn(__uint_as_float(i + MAGIC_BITS), MAGIC);
}
// the low bytes of four such floats, the first lowest
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b,
                                                   uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int DH, typename OutT, bool I8S, bool I8PV>
__global__ void __launch_bounds__(ATTN_THREADS, 1)
attn_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const AttnArgs p) {
  static_assert(!(I8S || I8PV) || DH == 64, "int8 variants: dh = 64");
  using C = AttnCfg<DH, I8S, I8PV>;
  using QK = typename C::QK;
  using VT = typename C::V;
  constexpr int NSTAGE = C::NSTAGE;
  // O: s32 under int8 PV, else f32; per 64-column box of the head
  using OAcc = std::conditional_t<I8PV, uint32_t, float>;
  using SAcc = std::conditional_t<I8S, uint32_t, float>;
  constexpr int NO = DH < 64 ? 16 : 32;   // accumulators per 64-column box
  constexpr int OB = DH / 64 + (DH < 64);  // O boxes
  extern __shared__ uint8_t attn_smem[];
  __shared__ __align__(8) uint64_t bars[2 * NSTAGE];   // full, then empty
  const uint32_t ring = (smem_u32(attn_smem) + 1023) & ~1023u;
  const uint32_t full = smem_u32(bars), empty = full + 8 * NSTAGE;

  const int n_real = p.n_real, n_tiles = (n_real + AK - 1) / AK;
  const int q0 = blockIdx.x * BQ;
  const int n_wg = min(2, (p.T - q0) / AQ);
  const long long off = blockIdx.z * p.sb + blockIdx.y * p.sh;
  const int row0 = (int)(off / p.st), col0 = (int)(off % p.st);
  const int bh = blockIdx.z * p.H + blockIdx.y;
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
        mbar_expect_tx(full + 8 * s, QK::BYTES + (pv ? VT::BYTES : 0));
        const uint32_t kd = ring + s * C::STAGE;
#pragma unroll
        for (int b = 0; b < QK::NBOX; ++b)   // columns: elements of K
          tma_load(kd + b * QK::BOX_BYTES, &tk,
                   col0 + b * QK::ROW / (I8S ? 1 : 2), row0 + key,
                   full + 8 * s);
        if (pv) {
          if constexpr (I8PV) {   // vq (B H 64, T): the head's 64 dh rows
            tma_load(kd + QK::BYTES, &tv, key, bh * 64, full + 8 * s);
          } else {
#pragma unroll
            for (int b = 0; b < VT::NBOX; ++b)
              tma_load(kd + QK::BYTES + b * VT::BOX_BYTES, &tv,
                       col0 + b * VT::ROW / 2, row0 + key, full + 8 * s);
          }
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

  // q of the warpgroup's 64 rows, stored as a K tile lies: the A operand
  // of QK^T, swizzled as the TMA swizzles K. bf16 q is scaled on the way
  // in (bf16(f32(q) * scale)); int8 q is copied as it is, its scale
  // entering the scores' row factors f0 (row r0), f1 (row r1).
  const uint32_t qs = ring + NSTAGE * C::STAGE + wg * QK::BYTES;
  float f0 = 0.f, f1 = 0.f;
  {
    constexpr int CPR = QK::BYTES / AQ / 16;    // 16-byte chunks a row
    constexpr int CPB = QK::ROW / 16;           // 16-byte chunks a box row
    const int tid = threadIdx.x & 127;
#pragma unroll
    for (int i = 0; i < AQ * CPR / 128; ++i) {
      const int ch = tid + i * 128, r = ch / CPR, c = ch % CPR;
      const long long row = off + (long long)(q0 + wg * AQ + r) * p.st;
      const uint32_t dst = qs + (c / CPB) * QK::BOX_BYTES + r * QK::ROW +
                           (QK::chunk(r, c % CPB) << 4);
      uint32_t v[4];
      if constexpr (I8S) {
        const int4 raw = *reinterpret_cast<const int4*>(p.qq + row + c * 16);
        v[0] = raw.x, v[1] = raw.y, v[2] = raw.z, v[3] = raw.w;
      } else {
        const int4 raw = *reinterpret_cast<const int4*>(p.q + row + c * 8);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 h =
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]);
          v[e] = pack_bf16(__fmul_rn(__low2float(h), p.q_scale),
                           __fmul_rn(__high2float(h), p.q_scale));
        }
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
    if constexpr (I8S) {
      const float ks = __fmul_rn(head_scale(p.kamax + bh * AMAX_PARTS),
                                 p.q_scale);
      const size_t q_row = ((size_t)blockIdx.z * p.T + r0) * p.H + blockIdx.y;
      f0 = __fmul_rn(p.qs[q_row], ks);
      f1 = __fmul_rn(p.qs[q_row + (size_t)8 * p.H], ks);
    }
  }

  // S = Q K^T of ring load `it` (its stage's K tile) as one wgmma group;
  // the first k-step writes S fresh
  auto issue_s = [&](SAcc (&s)[32], int it) {
    mbar_wait(full + 8 * (it % NSTAGE), (it / NSTAGE) & 1);
    const uint32_t kd = ring + (it % NSTAGE) * C::STAGE;
    wgmma_fence();
    if constexpr (I8S) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {       // 32 bytes of dh a step
        const uint64_t da = smem_desc(qs + kk * 32, QK::SBO, QK::SWIZZLE);
        const uint64_t db = smem_desc(kd + kk * 32, QK::SBO, QK::SWIZZLE);
        if (kk == 0)
          wgmma_s8_ss_n64<0>(s, da, db);
        else
          wgmma_s8_ss_n64<1>(s, da, db);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t at = (kk / 4) * QK::BOX_BYTES + (kk % 4) * 32;
        const uint64_t da = smem_desc(qs + at, QK::SBO, QK::SWIZZLE);
        const uint64_t db = smem_desc(kd + at, QK::SBO, QK::SWIZZLE);
        if (kk == 0)
          wgmma_ss_n64<0>(s, da, db);
        else
          wgmma_ss_n64<1>(s, da, db);
      }
    }
    wgmma_commit();
  };
  // one arrival per warpgroup frees ring load `it`'s stage
  auto release = [&](int it) {
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * (it % NSTAGE));
  };
  // int8 scores: s = f32(dot) * f of the row, in place (no-op for bf16)
  auto scale = [&](SAcc (&s)[32]) {
    if constexpr (I8S) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s_set(s[i], __fmul_rn(i2f_exact(s[i]), (i & 2) ? f1 : f0));
    }
  };
  // keys >= n_real at -1e30; selects, no branches: a branch that defines
  // accumulator registers while a wgmma is in flight serializes them
  auto mask = [&](SAcc (&s)[32], int kt) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_set(s[4 * j + e], kt * AK + j * 8 + t * 2 + (e & 1) >= n_real
                                ? -1e30f : s_get(s[4 * j + e]));
  };

  // pass 1: row max, two tiles at a time (the second's scores are computed
  // while the first's max is taken); the last tile alone, masked. Every
  // group is retired before a loop's back edge. With int8 scores the max
  // is taken over the integer dots and scaled once: f32 conversion and a
  // product by f > 0 keep the order, so the result is the max of the
  // scaled scores.
  SAcc sa[32], sb[32];
  float m0 = -3.0e38f, m1 = -3.0e38f;
  int im0 = INT_MIN, im1 = INT_MIN;
  auto tile_max = [&](SAcc (&s)[32]) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (I8S) {
        im0 = max(im0, max((int)s[4 * j], (int)s[4 * j + 1]));
        im1 = max(im1, max((int)s[4 * j + 2], (int)s[4 * j + 3]));
      } else {
        m0 = fmaxf(m0, fmaxf(s_get(s[4 * j]), s_get(s[4 * j + 1])));
        m1 = fmaxf(m1, fmaxf(s_get(s[4 * j + 2]), s_get(s[4 * j + 3])));
      }
    }
  };
  // the last tile's keys >= n_real out of the max
  auto mask_max = [&](SAcc (&s)[32], int kt) {
    if constexpr (I8S) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = kt * AK + j * 8 + t * 2 + (e & 1) >= n_real
                             ? 0x80000000u : s[4 * j + e];
    } else {
      mask(s, kt);
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
    if (kt == n_tiles - 1) mask_max(sa, kt);
    tile_max(sa);
  }
  if constexpr (I8S) {   // a thread may see masked keys only: INT_MIN
    m0 = __fmul_rn(__int2float_rn(im0), f0);
    m1 = __fmul_rn(__int2float_rn(im1), f1);
  }
#pragma unroll
  for (int off2 = 1; off2 <= 2; off2 <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off2));
  }

  // pass 2: p = exp(s - m), l += p, O += bf16(p) V (int8 PV: pq = rint(p
  // 127), l += pq, O_int += pq vq), in FA3's order: the scores of tile kt
  // and the PV product of tile kt - 1 are issued together, and tile kt's
  // exp runs while the tensor cores finish that product. O starts at zero
  // while no wgmma is in flight; every PV product then accumulates into it
  // in place.
  OAcc o[OB][NO];
#pragma unroll
  for (int b = 0; b < OB; ++b) {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[b][i] = 0;
    fence_regs(o[b]);
  }
  // A fragments of p: bf16, 16 keys each (4 steps a tile), or int8, 32
  // keys each (2 steps)
  constexpr int KSTEPS = I8PV ? 2 : 4;
  uint32_t pa[KSTEPS][4];
  float l0 = 0.f, l1 = 0.f;
  uint32_t lq0 = 0, lq1 = 0;   // int8 PV: sums of the pq floats' bits
  const int it0 = n_tiles;           // pass 2's first ring load
  auto issue_pv = [&](int it) {
    const uint32_t vd = ring + (it % NSTAGE) * C::STAGE + QK::BYTES;
    wgmma_fence();
    if constexpr (I8PV) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)   // 32 keys (bytes) a step
        wgmma_s8_rs_n64(o[0], pa[kk],
                        smem_desc(vd + kk * 32, VT::SBO, VT::SWIZZLE));
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int b = 0; b < VT::NBOX; ++b) {
          const uint64_t desc = smem_desc(
              vd + b * VT::BOX_BYTES + kk * 16 * VT::ROW, VT::SBO,
              VT::SWIZZLE);
          if constexpr (DH < 64)
            wgmma_rs_n32(o[b], pa[kk], desc);
          else
            wgmma_rs_n64(o[b], pa[kk], desc);
        }
    }
    wgmma_commit();
  };
  auto softmax = [&]() {             // in place on sa
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pe[e] = exp_sfu(__fsub_rn(s_get(sa[4 * j + e]), e < 2 ? m0 : m1));
      if constexpr (I8PV) {   // pq = rint(p * 127) in 1.5 2^23 + pq
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = __fadd_rn(__fmul_rn(pe[e], 127.0f), MAGIC);
          (e < 2 ? lq0 : lq1) += __float_as_uint(y);
          s_set(sa[4 * j + e], y);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_set(sa[4 * j + e], pe[e]);
        l0 += pe[0] + pe[1];
        l1 += pe[2] + pe[3];
      }
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      if constexpr (I8PV) {   // sa[4 j + e]: keys 8 j + 2 t + e % 2
        const SAcc* s = sa + 16 * kk;
        pa[kk][0] = pack_low_bytes(s_bits(s[0]), s_bits(s[1]), s_bits(s[4]),
                                   s_bits(s[5]));
        pa[kk][1] = pack_low_bytes(s_bits(s[2]), s_bits(s[3]), s_bits(s[6]),
                                   s_bits(s[7]));
        pa[kk][2] = pack_low_bytes(s_bits(s[8]), s_bits(s[9]), s_bits(s[12]),
                                   s_bits(s[13]));
        pa[kk][3] = pack_low_bytes(s_bits(s[10]), s_bits(s[11]),
                                   s_bits(s[14]), s_bits(s[15]));
      } else {
        pa[kk][0] = pack_bf16(s_get(sa[8 * kk]), s_get(sa[8 * kk + 1]));
        pa[kk][1] = pack_bf16(s_get(sa[8 * kk + 2]), s_get(sa[8 * kk + 3]));
        pa[kk][2] = pack_bf16(s_get(sa[8 * kk + 4]), s_get(sa[8 * kk + 5]));
        pa[kk][3] = pack_bf16(s_get(sa[8 * kk + 6]), s_get(sa[8 * kk + 7]));
      }
    }
  };
  // S of tile kt with the PV product of tile kt - 1; the last tile masked
  auto step = [&](int kt, auto last) {
    issue_s(sa, it0 + kt);
    issue_pv(it0 + kt - 1);
    wgmma_wait<1>();
    fence_regs(sa);
    scale(sa);
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
  scale(sa);
  if (n_tiles == 1) mask(sa, 0);
  softmax();
  pack();
  for (kt = 1; kt + 1 < n_tiles; ++kt) step(kt, Flag<false>{});
  if (n_tiles > 1) step(n_tiles - 1, Flag<true>{});
  issue_pv(it0 + n_tiles - 1);
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < OB; ++b) fence_regs(o[b]);

  float sv = 1.f;
  if constexpr (I8PV) {
#pragma unroll
    for (int off2 = 1; off2 <= 2; off2 <<= 1) {
      lq0 += __shfl_xor_sync(0xffffffffu, lq0, off2);
      lq1 += __shfl_xor_sync(0xffffffffu, lq1, off2);
    }
    // less the 64 magic floats of each tile's row, mod 2^32; sum pq <=
    // 127 T < 2^24: exact in f32, as the reference's f32 sum
    const uint32_t magic = 64u * (uint32_t)n_tiles * MAGIC_BITS;
    l0 = fmaxf((float)(int)(lq0 - magic), 1.0f);
    l1 = fmaxf((float)(int)(lq1 - magic), 1.0f);
    sv = head_scale(p.vamax + bh * AMAX_PARTS);
  } else {
#pragma unroll
    for (int off2 = 1; off2 <= 2; off2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off2);
    }
  }
  auto out = [&](OAcc x, float l) {
    float v;
    if constexpr (I8PV)
      v = __fmul_rn(__fdiv_rn(__int2float_rn((int)x), l), sv);
    else
      v = __fdiv_rn(x, l);
    return v;
  };

  OutT* O = static_cast<OutT*>(p.o) + off;
#pragma unroll
  for (int b = 0; b < OB; ++b)
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = b * 64 + j * 8 + t * 2;
      const float v00 = out(o[b][4 * j], l0);
      const float v01 = out(o[b][4 * j + 1], l0);
      const float v10 = out(o[b][4 * j + 2], l1);
      const float v11 = out(o[b][4 * j + 3], l1);
      if constexpr (sizeof(OutT) == 4) {
        *reinterpret_cast<float2*>(O + r0 * p.st + c) = make_float2(v00, v01);
        *reinterpret_cast<float2*>(O + r1 * p.st + c) = make_float2(v10, v11);
      } else {
        *reinterpret_cast<uint32_t*>(O + r0 * p.st + c) = pack_bf16(v00, v01);
        *reinterpret_cast<uint32_t*>(O + r1 * p.st + c) = pack_bf16(v10, v11);
      }
    }
}

// z as a (rows, cols) matrix of row pitch cols, bf16 or int8 (I8), in boxes
// of 64 rows by one Tile<RB> box row
template <int RB, bool I8>
inline bool tile_tensor_map(CUtensorMap* map, const void* z, long long rows,
                            long long cols) {
  using L = Tile<RB>;
  constexpr int ES = I8 ? 1 : 2;             // bytes an element
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t pitch[1] = {(cuuint64_t)cols * ES};
  const cuuint32_t box[2] = {(cuuint32_t)(L::ROW / ES), (cuuint32_t)AK};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map,
             I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(z), dims, pitch, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// grid (ceil(T / 128), H, B); a.sb, a.sh, a.st as AttnArgs says. K: a.k
// (bf16) or a.kq (int8, I8S) in the layout of q; V: a.v (bf16, the same
// layout) or a.vq ((B H 64, T) int8, I8PV).
template <int DH, typename OutT, bool I8S = false, bool I8PV = false>
inline cudaError_t launch_attn_wgmma(AttnArgs a, int B, int H, int T,
                                     cudaStream_t st) {
  using C = AttnCfg<DH, I8S, I8PV>;
  a.T = T;
  a.H = H;
  CUtensorMap tk, tv;
  const long long rows = (long long)B * a.sb / a.st;
  const bool ok =
      (I8S ? tile_tensor_map<DH, true>(&tk, a.kq, rows, a.st)
           : tile_tensor_map<2 * DH, false>(&tk, a.k, rows, a.st)) &&
      (I8PV ? tile_tensor_map<AK, true>(&tv, a.vq, (long long)B * H * 64, T)
            : tile_tensor_map<2 * DH, false>(&tv, a.v, rows, a.st));
  if (!ok) return cudaErrorInvalidValue;
  // at every launch: a static flag here would be one symbol for every
  // library that includes this file (K12's too), each with its own kernel
  cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<DH, OutT, I8S, I8PV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  attn_wgmma_kernel<DH, OutT, I8S, I8PV>
      <<<dim3((T + BQ - 1) / BQ, H, B), ATTN_THREADS, C::SMEM, st>>>(tk, tv,
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

// the flat path at dh = 64 (K1, K1-o, K3's int8 entry): the instantiation
// of the flags' int8 scores and PV; output in f32 for the fused o
// projection
template <typename OutT>
inline cudaError_t launch_attn_flat(const AttnArgs& a, int flags, int T,
                                    int H, int B, cudaStream_t st) {
  switch (flags & (I8_SCORES | I8_PV)) {
    case 0: return launch_attn_wgmma<64, OutT>(a, B, H, T, st);
    case I8_SCORES:
      return launch_attn_wgmma<64, OutT, true, false>(a, B, H, T, st);
    case I8_PV: return launch_attn_wgmma<64, OutT, false, true>(a, B, H, T, st);
    default: return launch_attn_wgmma<64, OutT, true, true>(a, B, H, T, st);
  }
}

// ---------------------------------------------------------------------------
// int8 variants' preparation
// ---------------------------------------------------------------------------

// Two launches, no memset and no atomics. The per-head absmax needs every
// real row of a head before any of its values is quantized, so the first
// launch takes the statistics (and quantizes q, which needs only its own
// row) and the second quantizes k and v (AMAX_PARTS: above).

// Launch 1. Blocks [0, n_amax): one part of the absmax of k or v (z = z0 +
// block / (B H P): 0 k, 1 v) of one (batch row, head) over its share of the
// rows < n_real, written as float bits to amax[((z B + b) H + h) P + part]
// (non-negative floats order like their bit patterns). The rest: q (B T
// rows, H heads of 64, in TQ: K1 f32, K3 bf16) -> qq = clip(rint(q / sq)),
// sq = max(absmax of the row's head, 1e-6) / 127 at qs[row H + h]; a group
// of 16-byte lanes per (row, head).
template <typename TQ>
__global__ void __launch_bounds__(256)
i8_stats_kernel(const TQ* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, int8_t* __restrict__ qq,
                float* __restrict__ qs, unsigned* __restrict__ amax, int B,
                int T, int H, int n_real, int n_amax, int z0) {
  const int d = 64 * H;
  if ((int)blockIdx.x < n_amax) {
    __shared__ float red[8];
    const int part = blockIdx.x % AMAX_PARTS, head = blockIdx.x / AMAX_PARTS;
    const int bh = head % (B * H), z = z0 + head / (B * H);
    const int b = bh / H, h = bh % H;
    const int per = (n_real + AMAX_PARTS - 1) / AMAX_PARTS;
    const int r_hi = min(n_real, (part + 1) * per);
    const bf16* src = (z ? v : k) + (size_t)b * T * d + h * 64 +
                      (threadIdx.x & 7) * 8;   // 8 lanes a 128-byte row
    float m = 0.f;
#pragma unroll 4
    for (int r = part * per + (threadIdx.x >> 3); r < r_hi; r += 32) {
      const int4 raw = *reinterpret_cast<const int4*>(src + (size_t)r * d);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        m = fmaxf(m, fmaxf(fabsf(__low2float(h2[e])),
                           fabsf(__high2float(h2[e]))));
    }
    m = warp_max(m);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < 8; ++w) m = fmaxf(m, red[w]);
      amax[((size_t)z * B * H + bh) * AMAX_PARTS + part] = __float_as_uint(m);
    }
    return;
  }
  constexpr int EPL = 16 / sizeof(TQ);     // values a lane: 8 bf16, 4 f32
  constexpr int L = 64 / EPL;              // lanes a (row, head)
  // B T H is a multiple of 64: a warp's groups are all in range or all out
  const long long w = (long long)(blockIdx.x - n_amax) * (256 / L) +
                      threadIdx.x / L;
  if (w >= (long long)B * T * H) return;
  const int lane = threadIdx.x % L;
  const long long off = w * 64 + lane * EPL;
  const int4 raw = *reinterpret_cast<const int4*>(q + off);
  const TQ* x = reinterpret_cast<const TQ*>(&raw);
  float a = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) a = fmaxf(a, fabsf(to_f32(x[e])));
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
  const float s = __fdiv_rn(fmaxf(a, 1e-6f), 127.0f);
  uint32_t packed[EPL / 4];
#pragma unroll
  for (int e = 0; e < EPL / 4; ++e)
    packed[e] = (uint32_t)(uint8_t)quant_s8(to_f32(x[4 * e]), s) |
                ((uint32_t)(uint8_t)quant_s8(to_f32(x[4 * e + 1]), s) << 8) |
                ((uint32_t)(uint8_t)quant_s8(to_f32(x[4 * e + 2]), s) << 16) |
                ((uint32_t)(uint8_t)quant_s8(to_f32(x[4 * e + 3]), s) << 24);
  if constexpr (EPL == 8)
    *reinterpret_cast<uint2*>(qq + off) = make_uint2(packed[0], packed[1]);
  else
    *reinterpret_cast<uint32_t*>(qq + off) = packed[0];
  if (lane == 0) qs[w] = s;
}

// clip(rint(z * inv)) of a bf16 value as int8
__device__ __forceinline__ int quant_by(bf16 z, float inv) {
  const float x = rintf(__fmul_rn(__bfloat162float(z), inv));
  return (int)fminf(fmaxf(x, -127.0f), 127.0f);
}

// eight int8 values, the first lowest
__device__ __forceinline__ uint2 quant8(const int4& raw, float inv) {
  const bf16* zv = reinterpret_cast<const bf16*>(&raw);
  uint32_t w[2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
    w[e] = (uint32_t)(uint8_t)quant_by(zv[4 * e], inv) |
           ((uint32_t)(uint8_t)quant_by(zv[4 * e + 1], inv) << 8) |
           ((uint32_t)(uint8_t)quant_by(zv[4 * e + 2], inv) << 16) |
           ((uint32_t)(uint8_t)quant_by(zv[4 * e + 3], inv) << 24);
  return make_uint2(w[0], w[1]);
}

// Launch 2: k and v times the reciprocal of their head's scale, clipped and
// rounded, one block per 64 keys of one (batch row, head): blocks [0, n_k)
// k into kq in k's (B, T, d) layout; the rest v into vq (B, H, 64, T),
// transposed per head, row (b H + h) 64 + c holding column c of the head's
// keys, key t at (t & ~63) + key_slot(t % 64), the tile turned in shared
// memory so that reads and writes are 16-byte chunks.
__global__ void __launch_bounds__(256)
i8_quant_kv_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                   int8_t* __restrict__ kq, int8_t* __restrict__ vq,
                   const unsigned* __restrict__ amax, int B, int T, int H,
                   int n_k) {
  __shared__ __align__(16) int8_t tile[64][64 + 16];   // [dh][slot]
  const int d = 64 * H, is_v = (int)blockIdx.x >= n_k;
  const int blk = blockIdx.x - (is_v ? n_k : 0), nt = T / 64;
  const int t0 = (blk % nt) * 64, h = (blk / nt) % H, b = blk / nt / H;
  const float inv = __fdiv_rn(
      1.0f, head_scale(amax + ((size_t)is_v * B * H + (size_t)b * H + h) *
                                  AMAX_PARTS));
  const bf16* src = (is_v ? v : k) + ((size_t)b * T + t0) * d + h * 64;
  int4 raw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {            // 64 keys x 8 chunks of 8 values
    const int c = threadIdx.x + i * 256;
    raw[i] = *reinterpret_cast<const int4*>(src + (size_t)(c >> 3) * d +
                                            (c & 7) * 8);
  }
  if (!is_v) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * 256;
      *reinterpret_cast<uint2*>(kq + ((size_t)b * T + t0 + (c >> 3)) * d +
                                h * 64 + (c & 7) * 8) = quant8(raw[i], inv);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * 256, c0 = (c & 7) * 8;
    const int slot = key_slot(c >> 3);
    const uint2 q8 = quant8(raw[i], inv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      tile[c0 + e][slot] = (int8_t)(((e < 4 ? q8.x : q8.y) >> (8 * (e & 3))) & 0xff);
  }
  __syncthreads();
  const int r = threadIdx.x >> 2, c16 = (threadIdx.x & 3) * 16;
  *reinterpret_cast<int4*>(vq + ((size_t)(b * H + h) * 64 + r) * T + t0 +
                           c16) = *reinterpret_cast<const int4*>(&tile[r][c16]);
}

// q (B, T, d) in TQ (K1: f32 unscaled; K3: bf16), k, v (B, T, d) bf16;
// d = 64 H, T % 64 == 0. Writes what the flags ask for: qq, qs (int8
// scores), kq (int8 scores; (B, T, d)), vq (int8 PV; (B, H, 64, T) as
// i8_quant_kv_kernel lays it); amax: (2, B, H, AMAX_PARTS) u32 scratch.
template <typename TQ>
inline cudaError_t int8_prep(const TQ* q, const bf16* k, const bf16* v,
                             int flags, int8_t* qq, float* qs, int8_t* kq,
                             int8_t* vq, unsigned* amax, int B, int T, int d,
                             int n_real, cudaStream_t st) {
  const int H = d / 64;
  const bool s8 = flags & I8_SCORES, pv = flags & I8_PV;
  const int n_amax = (s8 + pv) * B * H * AMAX_PARTS;
  constexpr int GROUPS = 256 * 16 / (64 * (int)sizeof(TQ));   // a block
  const long long n_q = s8 ? ((long long)B * T * H + GROUPS - 1) / GROUPS : 0;
  i8_stats_kernel<TQ><<<(unsigned)(n_amax + n_q), 256, 0, st>>>(
      q, k, v, qq, qs, amax, B, T, H, n_real, n_amax, s8 ? 0 : 1);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int tiles = T / 64 * H * B;
  i8_quant_kv_kernel<<<(unsigned)((s8 + pv) * tiles), 256, 0, st>>>(
      k, v, kq, vq, amax, B, T, H, s8 ? tiles : 0);
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
              am, am + (size_t)B * H * AMAX_PARTS, T, H};
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
             static_cast<const int8_t*>(vq), am,
             am + (size_t)B * H * AMAX_PARTS, T, H};
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
