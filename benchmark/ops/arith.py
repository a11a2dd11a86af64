"""Operations, bytes and least times: the benchmark's frozen arithmetic.

Copied from ``chip_smoke.py`` as of the port's twenty-first slice
(``_bound_mixed`` :743, ``_bound_int8`` :751, ``_bound`` :994, K1's and
K2's bounds in ``phase_kernels`` :364, ``_train_step_flop`` :4584), with
the counts taken at the real positions a window has (1500), whatever
pads them: the work a block needs, not what a kernel does.

Peaks: NVIDIA's H100 SXM data sheet, dense: 1,979 TOP/s int8, 989 TFLOP/s
bf16, 3.35 TB/s of HBM3. Operations count a multiply-add as two.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(nbytes: float, int8_ops: float = 0.0,
            bf16_flops: float = 0.0) -> float:
    """The least time (s): int8 and bf16 tensor-core work at their peaks,
    one after the other, against the bytes at the memory's peak."""
    return max(nbytes / PEAK_BYTES,
               int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS)


def attention_block(windows: int, t: int, d: int):
    """(int8 ops, bf16 flops, bytes) of one encoder layer's attention
    block on ``windows`` windows of ``t`` positions: LayerNorm, the int8
    q/k/v projections, scores and their product with v (K1's work; the o
    projection is not part of it). Bytes: bf16 x in and out, the int8
    q/k/v weights, their f32 scales and biases, the f32 LayerNorm."""
    m = windows * t
    int8_ops = 2.0 * m * d * 3 * d
    bf16_flops = 4.0 * windows * t * t * d
    nbytes = 2 * m * d * 2 + 3 * d * d + 3 * d * 4 + 4 * d * 4
    return int8_ops, bf16_flops, nbytes


def mlp_block(windows: int, t: int, d: int, f: int):
    """(int8 ops, bytes) of one encoder layer's int8 MLP (K2's work):
    LayerNorm, fc1, GELU, fc2 and the residual. Bytes: bf16 x in and out,
    both int8 weights, their f32 scales and biases, the f32 LayerNorm."""
    m = windows * t
    ops = 2.0 * m * d * f * 2
    nbytes = 2 * m * d * 2 + 2 * d * f + (f + d) * 4 * 2 + 2 * d * 4
    return ops, nbytes


def encoder_window(c: dict, t: int = 1500):
    """(int8 ops, bf16 flops) of one window through the encoder: the stem
    (bf16), the linears of every layer (int8: q, k, v, o, the MLP), the
    scores and their product with v (bf16)."""
    d, m, f = c["d_model"], c["num_mel_bins"], c["encoder_ffn_dim"]
    stem = 2 * 2 * t * 3 * m * d + 2 * t * 3 * d * d
    lin = c["encoder_layers"] * (8 * t * d * d + 4 * t * d * f)
    core = c["encoder_layers"] * 4 * t * t * d
    return float(lin), float(stem + core)


def decoder_row(c: dict, s: int, t: int = 1500) -> float:
    """bf16 flops of one row's decoder work over ``s`` positions (its
    prompt and the tokens fed back), as ``_train_step_flop`` counts a
    forward: per layer 28 s d^2 (self q/k/v/o, cross q/o, the MLP at 4d),
    4 s^2 d (self-attention), 4 t d^2 (the cross k and v), 4 s t d (the
    cross-attention), then 2 s d V for the logits."""
    d, v = c["d_model"], c["vocab_size"]
    f = c["decoder_ffn_dim"]
    per = (12 * s * d * d + 4 * s * d * f + 4 * s * s * d + 4 * t * d * d
           + 4 * s * t * d)
    return float(c["decoder_layers"] * per + 2 * s * d * v)


def batch_least_s(c: dict, prompt_lens, sample_len: int) -> float:
    """The least time of one batch: each row's window through the
    encoder (int8 and bf16 at their peaks) and its decoder work over its
    prompt and ``sample_len`` - 1 fed-back tokens (bf16)."""
    i8, bf = encoder_window(c)
    rows = len(prompt_lens)
    dec = sum(decoder_row(c, p + sample_len - 1) for p in prompt_lens)
    return (rows * i8 / PEAK_INT8_OPS
            + (rows * bf + dec) / PEAK_BF16_FLOPS)
