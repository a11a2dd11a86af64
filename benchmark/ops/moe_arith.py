"""Operations, bytes and least times of the Uni-MoE family: its batches'
least time (``mfu``) and its expert layers' least time (``moe_roofline``).

Peaks as ``arith.py``'s (NVIDIA's H100 SXM data sheet, dense): 1,979
TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s. Operations count a multiply-add
as two. Shapes come from the model file's published keys.
"""

from __future__ import annotations

from benchmark.ops.arith import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_INT8_OPS,
                                 encoder_window)

BF16 = 2          # bytes an element of a weight or an activation


def _dims(c: dict):
    d, h = c["hidden_size"], c["num_attention_heads"]
    hd = d // h
    return d, h * hd, c["num_key_value_heads"] * hd


def expert_least_s(c: dict, tokens: int, rows) -> float:
    """The least time of one layer's experts in one forward: ``rows`` the
    real tokens each routed expert took (the null's need nothing),
    ``tokens`` the real tokens, each taken by every shared expert. The
    larger of the operations at the bf16 peak (6 d width a row of an
    expert: gate, up and down) and the bytes at the memory's (each expert
    hit's three weights once, its rows' activations in and out)."""
    d, f = c["hidden_size"], c["dynamic_intermediate_size"]
    n_s, fs = c["mlp_fixed_expert_num"], c["shared_intermediate_size"]
    rows = [int(r) for r in rows[:c["mlp_dynamic_expert_num"]]]
    ops = 6.0 * d * (f * sum(rows) + fs * n_s * tokens)
    hit = sum(1 for r in rows if r > 0)
    weights = 3 * d * BF16 * (f * hit + (fs * n_s if tokens else 0))
    acts = 2 * d * BF16 * (sum(rows) + n_s * tokens)
    return max(ops / PEAK_BF16_FLOPS, (weights + acts) / PEAK_BYTES)


def records_least_s(c: dict, experts) -> float:
    """The summed least time of every forward and layer of the batch
    records' expert counts: (tokens (F,), rows (F, layers, experts), ...)
    each."""
    total = 0.0
    for rec in experts:
        tokens, rows = rec[0], rec[1]
        for f in range(len(tokens)):
            for layer in range(rows.shape[1]):
                total += expert_least_s(c, int(tokens[f]), rows[f, layer])
    return total


def token_flops(c: dict, context: int) -> float:
    """bf16 flops of one token through the language model at ``context``
    positions: per layer the q, k, v and o projections, the scores and
    their product with v, the gate, the routed experts at the cap of
    ``mlp_dynamic_top_k`` slots, the shared experts."""
    d, hq, hkv = _dims(c)
    e = c["mlp_dynamic_expert_num"] + c["mlp_dynamic_null_expert_num"]
    per = (2 * d * (2 * hq + 2 * hkv) + 4 * context * hq + 2 * d * e
           + 6 * d * (c["mlp_dynamic_top_k"] * c["dynamic_intermediate_size"]
                      + c["mlp_fixed_expert_num"]
                      * c["shared_intermediate_size"]))
    return float(c["num_hidden_layers"] * per)


def row_flops(c: dict, prompt: int, steps: int) -> float:
    """bf16 flops of one row: its prompt and ``steps`` - 1 tokens fed
    back, the head at the prompt's last position and at each fed-back
    token, the connector over its audio tokens."""
    n = prompt + steps - 1
    lm = sum(token_flops(c, s) for s in range(1, n + 1))
    head = 2.0 * c["hidden_size"] * c["vocab_size"] * steps
    con = 2.0 * c["tower"]["d_model"] * c["hidden_size"] \
        * c["whisper_query_tokens_size"]
    return lm + head + con


def batch_least_s(c: dict, prompt_lens, steps: int) -> float:
    """The least time of one batch: each row's window through the tower
    (int8 and bf16 at their peaks) and its language-model work."""
    i8, bf = encoder_window(c["tower"])
    rows = len(prompt_lens)
    lm = sum(row_flops(c, p, steps) for p in prompt_lens)
    return rows * i8 / PEAK_INT8_OPS + (rows * bf + lm) / PEAK_BF16_FLOPS
