// K12 nwt_encoder_layer_fused: one whole int8 encoder layer, LN1 + q/k/v +
// attention + o projection + residual, then LN2 + int8 MLP + residual.
// Replaces nobs_whisper_tpu/ops/fused_layer.py::encoder_layer_fused
// (pallas_call at :217, kernel _layer_kernel :49), taken under
// NWT_ATTN_FUSED=3.
//
// Its function is exactly K1 with the o projection fused (the int8 scores
// and PV variants included), the result rounded to bf16 (fused_layer.py:129),
// then K2's resident MLP at K12's own fc2-input chunk (NWT_MLP_BF or 1280).
// So this entry point launches those pieces in sequence on one stream:
// encoder_attention.cu's K1 (LN1 + quant, the q/k/v GEMM, the int8
// variants' preparation, attention, the per-pair quantization, the o GEMM
// from x + bo) and fused_mlp.cu's K2 (LN2 + quant, fc1 + gelu + requant
// across a cluster on int8 wgmma, fc2 from x2 + b2). K1's quantized-row
// scratch is reused for LN2's.
//
// Bound on an H100 at large-v3-turbo, B = 2 windows (T = 1536, n_real =
// 1500, d = 1280, H = 20, ffn = 5120): 121 G int8 operations (q/k/v 30.2,
// o 10.1, MLP 80.5) and 23.6 GFLOP of bf16 attention, about 0.085 ms at
// the published peaks; its bytes (x in, out, the 19.7 MB of weights) about
// 0.011 ms: compute-bound.
//
// What the TPU kernel keeps on chip that this version sends through device
// memory: the TPU kernel holds the f32 (T, d) attention accumulator in VMEM
// and feeds it straight to the MLP step, so a layer reads one (B, T, d)
// block and writes one. Here q/k/v, the f32 attention output and its int8
// copy, the bf16 residual between the halves and fc1's int8 output each
// make a device-memory round trip. Keeping them on chip (a persistent
// kernel per row block) is later work.

#include "encoder_attention.cu"
#include "fused_mlp.cu"

// K1's arguments (flags must hold FUSE_O; out receives x2, the attention
// half's bf16 output), then LN2, fc1 (w1t (F, d) int8: w1's K-major copy;
// s1, b1 (F,) f32), fc2 (w2t (d, F) int8: w2's; s2, b2 (d,) f32), K2's
// workspace a (M, F) f32 (read only on its two-pass variant), amax (M, F /
// block_f) u32, aq_mlp (M, F) int8, and the layer's output (B, T, d) bf16.
// F % block_f == 0, block_f % 128 == 0.
extern "C" int nwt_encoder_layer_fused(
    NWT_K1_ARGS, const void* ln2_g, const void* ln2_b, const void* w1t,
    const void* s1, const void* b1, const void* w2t, const void* s2,
    const void* b2, void* a_mlp, void* amax_mlp, void* aq_mlp, void* y,
    int B, int T, int d, int n_real, int F, int block_f, float sm_scale,
    int flags, void* stream) {
  if (!(flags & FUSE_O)) return (int)cudaErrorInvalidValue;
  cudaError_t e = encoder_attention_fused_qkv(
      NWT_K1_PASS, B, T, d, n_real, sm_scale, flags,
      reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return encoder_mlp_int8<bf16>(out, ln2_g, ln2_b, w1t, s1, b1, w2t, s2, b2,
                                y, xq, sx, a_mlp, amax_mlp, aq_mlp, B * T, d,
                                F, block_f, stream);
}
