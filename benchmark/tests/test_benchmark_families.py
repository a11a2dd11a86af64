"""The Whisper family (``families/whisper.py``) against what it stands
for: the same vocabulary, weights, engine, judgement and least times as
the weight maker, reference and arithmetic called directly."""

import numpy as np
import pytest
import torch

from benchmark import harness, traffic
from benchmark.ops import arith
from benchmark.reference import check
from benchmark.reference.tokens import (Encoder, byte_level_vocab, layout,
                                        prompt_tokens)
from benchmark.weights import make_tree

import tiny

CELLS = ["turbo-dictation", "v3-chunks"]
SEED = 2**31 + 606


@pytest.fixture(scope="module", params=CELLS)
def cell(request):
    return tiny.cell(request.param)


def test_a_config_without_family_is_whispers(cell):
    assert "family" not in cell.model
    assert cell.family.__file__.endswith("/benchmark/families/whisper.py")


def test_vocabulary_and_layout_as_before(cell):
    lay, vocab, enc = cell.family.vocabulary(cell.model)
    want = layout(cell.model["vocab_size"])
    assert lay == want
    assert vocab == byte_level_vocab(want)
    text = " the quick brown fox jumps over the lazy dog"
    assert enc.encode(text) == Encoder(vocab, want.eot).encode(text)


def _flat(node, path=()):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _flat(node[k], path + (k,))
    else:
        yield path, node


def test_engine_weights_as_before(cell):
    """The family's engine holds what the engine made from ``make_tree``
    holds, quantized alike, bit for bit."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.config import config_from_hparams
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
    m = cell.model
    _, vocab, _ = cell.family.vocabulary(m)
    got = cell.family.build_engine(cell, SEED, vocab, "cpu")
    cfg = config_from_hparams(
        n_vocab=m["vocab_size"], n_audio_ctx=m["max_source_positions"],
        n_audio_state=m["d_model"], n_audio_head=m["encoder_attention_heads"],
        n_audio_layer=m["encoder_layers"],
        n_text_ctx=m["max_target_positions"], n_text_state=m["d_model"],
        n_text_head=m["decoder_attention_heads"],
        n_text_layer=m["decoder_layers"], n_mels=m["num_mel_bins"],
        name=m["name"])
    tree = make_tree(m, SEED, cfg.eot, "cpu", dtype=torch.bfloat16)
    want = WhisperEngine(params=tree, cfg=cfg,
                         tokenizer=WhisperTokenizer(vocab, cfg),
                         compute_dtype=torch.bfloat16,
                         device=torch.device("cpu")).quantize()
    assert got.cfg == want.cfg and got.compute_dtype == want.compute_dtype
    a, b = list(_flat(got.params)), list(_flat(want.params))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), path
        else:
            assert x == y, path


def test_judge_as_the_plain_reference(cell):
    """On a fixed sample (prompts and served tokens made here, no serving
    run), the family's judgement and its control equal
    ``reference/check.py::judge`` on ``make_tree``'s weights, bit for
    bit."""
    m = cell.model
    lay = layout(m["vocab_size"])
    enc = Encoder(byte_level_vocab(lay), lay.eot)
    reqs = traffic.make_requests(cell.mix, SEED, 10.0, enc)[:2]
    rng = np.random.default_rng(3)
    sample = [dict(audio=r.audio, vocabulary=r.vocabulary, context=r.context,
                   prompt=prompt_tokens(enc, lay, r.vocabulary, r.context),
                   served=[int(t) for t in rng.integers(0, lay.eot, 6)])
              for r in reqs]
    got = cell.family.judge(cell, sample, SEED, "cpu", control_bits=4)
    want = check.judge(make_tree(m, SEED, lay.eot, "cpu",
                                 dtype=torch.bfloat16),
                       m, lay, enc, sample, "cpu", bits=8, control_bits=4)
    assert set(got) == {"widest_gap", "tokens_judged", "prompts_differ",
                        "row_gaps", "control_widest_gap"}
    assert got == want
    assert got["tokens_judged"] == 12 and got["prompts_differ"] == 0


def _run(cell):
    """Two steady batches and a profiled one, made by hand, with one
    launch of each of K1's and K2's kernels and a LayerNorm before each."""
    run = harness.Run(cell=cell, seconds=1.0)
    run.batches = [harness.Batch(0.0, 0.5, 3, [10, 40, 7], 48),
                   harness.Batch(0.5, 0.8, 1, [120], 48),
                   harness.Batch(1.0, 1.4, 2, [3, 5], 48, profiled=True)]
    run.kernels = [("ln_quant_kernel", 1.00, 1.01),
                   ("nwt::attn_wgmma_kernel", 1.01, 1.05),
                   ("ln_quant_kernel", 1.05, 1.06),
                   ("nwt::mlp_fc1_cluster_kernel", 1.06, 1.13)]
    return run


def test_readers_as_the_arithmetic(cell):
    m, run = cell.model, _run(cell)
    suffix = "dictation" if cell.mix["kind"] == "open_poisson" else "chunks"

    def read(name):
        return harness.reader(cell.bench_dir, f"{name}.{suffix}").read(run)
    least = (arith.batch_least_s(m, [10, 40, 7], 48)
             + arith.batch_least_s(m, [120], 48))
    assert read("mfu") == pytest.approx(100 * least / 0.8, rel=1e-12)
    d, f, n = m["d_model"], m["encoder_ffn_dim"], m["encoder_layers"]
    i8, bf, nb = arith.attention_block(2, 1500, d)
    assert read("attn_roofline") == pytest.approx(
        100 * n * arith.bound_s(nb, i8, bf) / 0.05, rel=1e-12)
    ops, nb = arith.mlp_block(2, 1500, d, f)
    assert read("mlp_roofline") == pytest.approx(
        100 * n * arith.bound_s(nb, ops) / 0.08, rel=1e-12)
