"""On the card (marked ``gpu``; it skips without one): the greedy decode
loop's CUDA graph (``decode/greedy.py::_StepGraph``) against the same loop
run eagerly (``decode_window_impl(..., cuda_graph=False)``), on a random
int8 tiny model at bf16: the graph replays the eager step's kernels on the
same inputs, so tokens, ``n_sampled`` and ``no_speech_prob`` are equal and
``sum_logprob`` equal (1e-5 relative allowed), with the plain, packed bf16
and int8 cross-KV, under the decode kernels' knobs, at B = 1, 5, 16 and
prompt pads of 8, 32 and 128. Replays count as the launches they replay;
a batch never reuses another's graph; the profiler's device trace holds
the replayed kernels by name.

This file imports neither JAX nor the JAX package; from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_decode_graph_gpu.py
"""

import collections

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SAMPLE_LEN = 20
# (name, q8_kv, xattn_bf16, knobs)
LAYOUTS = (
    ("plain", False, False, {}),
    ("packed", False, True, {}),
    ("packed-K4", False, True, {"NWT_XATTN_KERNEL": "1"}),
    ("packed-K6", False, True, {"NWT_Q8_KERNEL_MIN_BYTES": "1"}),
    ("int8", True, False, {}),
    ("int8-K5", True, False, {"NWT_Q8_KV_PALLAS": "1"}),
    ("int8-K5-K6", True, False, {"NWT_Q8_KV_PALLAS": "1",
                                 "NWT_Q8_KERNEL_MIN_BYTES": "1"}),
)
ROWS_PADS = ((1, 8), (5, 32), (16, 128))


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    eng = WhisperEngine.from_random("tiny", dtype=torch.bfloat16, seed=5,
                                    device="cuda").quantize(encoder=False)
    tables = build_rule_tables(eng.cfg, DecodeOptions(), device="cuda")
    return eng, tables


def _batch(cfg, rows, pad, seed):
    """Encoder states and left-padded prompts whose longest pads to
    ``pad``: [sot_prev, context..., sot, language, transcribe]."""
    from nobs_whisper_torch.decode.greedy import pad_prompts
    rng = np.random.RandomState(seed)
    lo = {8: 3, 32: 9, 128: 33}[pad]
    lens = rng.randint(lo, pad + 1, rows)
    lens[0] = pad
    prompts = []
    for n in lens:
        ctx = list(rng.randint(0, cfg.eot, n - 4)) if n > 3 else []
        head = [cfg.sot_prev] + ctx if n > 3 else []
        prompts.append(head + [cfg.sot, cfg.lang_base, cfg.transcribe])
    tokens, pads = pad_prompts(prompts, cfg.eot)
    assert tokens.shape[1] == pad
    sot = [pads[i] + p.index(cfg.sot) for i, p in enumerate(prompts)]
    xa = torch.from_numpy(rng.randn(rows, cfg.n_audio_ctx, cfg.n_audio_state)
                          .astype(np.float32)).to("cuda", torch.bfloat16)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long,
                                     device="cuda")
    return xa, as_t(tokens), as_t(pads), as_t(sot)


def _counts():
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops import attention_pallas as ap
    from nobs_whisper_torch.ops import quant as q
    return (collections.Counter(tw.decoder_forward_calls),
            ap.k4_launch_count, ap.k5_launch_count, q.k6_launch_count,
            q.k6_decode_launch_count)


def _decode(model, batch, q8_kv, xattn_bf16, cuda_graph):
    """(outputs on the host, the launch counts the decode added)."""
    from nobs_whisper_torch.decode.greedy import decode_window_impl
    eng, tables = model
    xa, tokens, pads, sot = batch
    before = _counts()
    out = decode_window_impl(
        eng.params, xa, tokens, pads, sot, tables,
        torch.zeros(xa.shape[0], device="cuda"), None, eng.cfg, SAMPLE_LEN,
        torch.bfloat16, q8_kv, xattn_bf16, sampling=False,
        cuda_graph=cuda_graph)
    torch.cuda.synchronize()
    after = _counts()
    added = (after[0] - before[0],) + tuple(
        a - b for a, b in zip(after[1:], before[1:]))
    return [z.cpu() for z in out], added


def _assert_same(graph, eager):
    (tok_g, n_g, lp_g, nsp_g), (tok_e, n_e, lp_e, nsp_e) = graph, eager
    assert torch.equal(tok_g, tok_e)
    assert torch.equal(n_g, n_e)
    assert torch.equal(nsp_g, nsp_e)
    torch.testing.assert_close(lp_g, lp_e, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("rows,pad", ROWS_PADS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=[x[0] for x in LAYOUTS])
def test_graph_matches_eager(model, layout, rows, pad, monkeypatch):
    name, q8_kv, xattn_bf16, knobs = layout
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    batch = _batch(model[0].cfg, rows, pad, seed=rows * 1000 + pad)
    eager, eager_n = _decode(model, batch, q8_kv, xattn_bf16, False)
    graph, graph_n = _decode(model, batch, q8_kv, xattn_bf16, True)
    _assert_same(graph, eager)
    assert graph_n == eager_n            # replays count as their launches
    calls, k4, k5, k6, k6_decode = graph_n
    assert sum(calls.values()) > 1
    assert (k4 > 0) == ("K4" in name) and (k5 > 0) == ("K5" in name)
    assert (k6_decode > 0) == ("K6" in name)
    print(f"[graph] {name} B={rows} pad={pad}: tokens equal, sum_logprob "
          f"{'bits equal' if torch.equal(graph[2], eager[2]) else 'close'};"
          f" launches {dict(calls)} K4 {k4} K5 {k5} K6 {k6}")


def test_batches_never_share_a_graph(model):
    """Batches of other sizes and inputs back to back, each held to its
    eager run."""
    for i, (rows, pad) in enumerate(((5, 32), (16, 8), (5, 128), (1, 32))):
        batch = _batch(model[0].cfg, rows, pad, seed=77 + i)
        graph, _ = _decode(model, batch, False, True, True)
        eager, _ = _decode(model, batch, False, True, False)
        _assert_same(graph, eager)


def test_the_batch_record_counts_the_replays(model):
    from nobs_whisper_torch.utils.profiling import Profiler
    prof = Profiler()
    batch = _batch(model[0].cfg, 5, 32, seed=9)
    with prof.batch([(0, 0)] * 5) as rec:
        _decode(model, batch, False, True, True)
    assert rec.calls["capture"] == 1 and rec.ns["capture"] > 0
    assert rec.replays == rec.calls["forward"] > 0
    assert rec.calls["rules"] <= 1
    assert rec.steps == rec.replays + rec.calls["rules"]


def _kernel_counts(fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(
        ev.name() for ev in prof.profiler.kineto_results.events()
        if ev.device_type() == DeviceType.CUDA)


def test_the_profiler_sees_the_replayed_kernels(model):
    """Captured and replayed under ``torch.profiler``, as the benchmark's
    traced batches are: every kernel of the eager run appears in the
    graph run's trace, by name, at least as often."""
    batch = _batch(model[0].cfg, 5, 32, seed=11)
    outs = {}

    def run(cuda_graph):
        outs[cuda_graph] = _decode(model, batch, False, True, cuda_graph)[0]
    eager = _kernel_counts(lambda: run(False))
    graph = _kernel_counts(lambda: run(True))
    _assert_same(outs[True], outs[False])
    short = {k: (n, graph[k]) for k, n in eager.items() if graph[k] < n}
    print(f"[profile] eager {sum(eager.values())} device activities, "
          f"graph {sum(graph.values())}; {len(eager)} names")
    assert sum(eager.values()) > SAMPLE_LEN * 4 and not short, short
