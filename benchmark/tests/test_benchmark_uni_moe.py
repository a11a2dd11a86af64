"""The Uni-MoE family (``families/uni_moe.py``) through the harness on the
CPU, at a tiny size of the published shape (a 2-layer Whisper tower of
width 128, 2 language-model layers of 7 query heads to a KV head, 4
routed experts, a null and 2 shared, 1024 ids): a sound run is correct,
the int4 control is not, a routing decision altered outside the ties
makes the run incorrect, and the expert readers read what
``ops/moe_arith.py`` counts by hand."""

import time

import numpy as np
import pytest

from benchmark import harness
from benchmark.ops import moe_arith
from benchmark.reference import uni_moe as ref

import tiny

SEED = 2**31 + 2027


def _cell(rows=4, sample_len=16, check_requests=2) -> harness.Cell:
    c = harness.load_cell(tiny.ROOT, "unimoe-chunks")
    c.model = dict(
        c.model, hidden_size=112, num_attention_heads=7,
        num_key_value_heads=1, num_hidden_layers=2, vocab_size=1024,
        endoftext=1000, dynamic_intermediate_size=96,
        shared_intermediate_size=32,
        tower=dict(c.model["tower"], d_model=128, encoder_layers=2,
                   encoder_attention_heads=2, encoder_ffn_dim=512))
    c.model["serving"] = dict(c.model["serving"], max_batch=rows)
    mix = dict(c.mix, check=dict(c.mix["check"], requests=check_requests),
               clients=rows, pool=2 * rows,
               batcher=dict(max_batch=rows, max_wait_ms=500.0))
    mix["decode"] = dict(mix["decode"], sample_len=sample_len)
    c.mix = mix
    c.limits = dict(c.limits, tokens_judged_min=check_requests * sample_len)
    return c


@pytest.fixture(scope="module")
def served():
    c = _cell()
    out = harness.execute(c, SEED, 3.0, False, time.perf_counter(),
                          device="cpu", control_bits=4)
    return c, out


def test_a_sound_run_is_correct_and_the_int4_control_is_not(served):
    c, out = served
    d = out["detail"]
    assert out["correct"], out["checks"]
    assert d["routing_mismatches"] == 0 and d["routing_missing"] == 0
    assert d["routing_decisions"] > 0
    assert d["tokens_judged"] == 32 and d["prompts_differ"] == 0
    assert d["control_widest_gap"] > c.limits["widest_gap"]


def test_a_decision_altered_outside_the_ties_is_incorrect(served):
    """The decision of the sampled request's (layer, position) farthest
    from a boundary, set to another expert in every record of the
    request: the check finds the mismatch."""
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    c, out = served
    run, fam = out["run"], c.family
    req = harness.sample_for_check(run.records, 2, SEED)[0]
    kept = [rt for p, s, rt in GLOBAL_PROFILER.routing_records()
            if p == tuple(req.prompt) and s == tuple(req.served)]
    assert kept
    r = ref.Reference(fam.base_tree(c.model, SEED, "cpu"), c.model,
                      lambda i: fam.layer(c.model, SEED, i, "cpu"))
    mel = ref.log_mel(req.req.audio, 128)[None]
    import torch
    audio = r.audio(r.encode(torch.from_numpy(mel)))[0]
    g = r.run([dict(tokens=req.prompt + req.served[:-1], audio=audio,
                    lo=len(req.prompt) - 1, decisions=kept[0])])[0]
    layer, pos = np.unravel_index(np.argmax(g["margin"]), g["margin"].shape)
    assert g["margin"][layer, pos] > fam.DELTA
    taken = set(int(e) for e in g["ids"][layer, pos] if e >= 0)
    other = next(e for e in range(4) if e not in taken)
    saved = [rt[layer, pos].copy() for rt in kept]
    try:
        for rt in kept:
            rt[layer, pos] = [other, -1]
        verdict = harness.check(c, run, SEED, "cpu")
    finally:
        for rt, v in zip(kept, saved):
            rt[layer, pos] = v
    assert not verdict["correct"]
    assert verdict["detail"]["routing_mismatches"] >= 1
    assert verdict["checks"]["widest_gap"]["value"] == float("inf")


def _least(c, tokens, rows):
    d, f, fs = 112, 96, 32
    ops = 6 * d * (f * sum(rows) + fs * 2 * tokens)
    nbytes = (3 * d * 2 * (f * sum(r > 0 for r in rows) + fs * 2)
              + 2 * d * 2 * (sum(rows) + 2 * tokens))
    return max(ops / 989e12, nbytes / 3.35e12)


def test_expert_readers_as_counted_by_hand():
    """A profiled batch of 3 rows, its record's expert counts (a prefill
    and one decode forward, 2 layers) and two ``moe_`` kernels of 1 ms:
    ``moe_ms_per_step`` and ``moe_roofline`` read the hand-counted
    numbers."""
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    c = _cell()
    tokens = np.array([30, 3])
    rows = np.zeros((2, 2, 5), np.int64)
    rows[0, 0] = [20, 10, 0, 0, 8]
    rows[0, 1] = [5, 5, 5, 5, 18]
    rows[1, 0] = [3, 0, 0, 0, 2]
    rows[1, 1] = [0, 1, 1, 1, 3]
    with GLOBAL_PROFILER.batch([(0, 0)] * 3) as rec:
        rec.experts = (tokens, rows, 4)
    run = harness.Run(cell=c, seconds=1.0)
    run.batches = [harness.Batch(0.0, 1.0, 3, [300, 310, 320], 16,
                                 profiled=True)]
    run.batch_sizes = [3]
    run.kernels = [("moe_gate_up_kernel", 0.0, 1e-3),
                   ("moe_down_kernel", 1e-3, 2e-3),
                   ("ampere_bf16_gemm", 2e-3, 5e-3)]
    read = lambda n: harness.reader(c.bench_dir, n).read(run)
    assert read("moe_ms_per_step.chunks") == pytest.approx(2.0 / 16)
    least = sum(_least(c, int(tokens[f]), list(rows[f, layer, :4]))
                for f in range(2) for layer in range(2))
    assert moe_arith.records_least_s(c.model, [rec.experts]) == \
        pytest.approx(least, rel=1e-12)
    assert read("moe_roofline.chunks") == pytest.approx(
        100 * least / 2e-3, rel=1e-12)
    run.kernels = run.kernels[2:]
    assert read("moe_ms_per_step.chunks") is None
    assert read("moe_roofline.chunks") is None


def test_batch_least_time_by_hand():
    """``mfu``'s least time: the tower at its peaks and each row's tokens
    through the language model at 2 routed slots a token."""
    c = _cell()
    m = c.model
    d, v, steps, p = 112, 1024, 16, 300
    per = lambda s: 2 * (2 * d * (2 * 112 + 2 * 16) + 4 * s * 112
                         + 2 * d * 5 + 6 * d * (2 * 96 + 2 * 32))
    lm = sum(per(s) for s in range(1, p + steps)) + 2 * d * v * steps \
        + 2 * 128 * d * 200
    i8, bf = moe_arith.encoder_window(m["tower"])
    assert moe_arith.batch_least_s(m, [p], steps) == pytest.approx(
        i8 / 1979e12 + (bf + lm) / 989e12, rel=1e-12)
