"""The speech LM of ``models/uni_moe.py`` (Uni-MoE-2.0-Omni's
audio-to-text path) against its plain reference (``plain_uni_moe.py``, a
copy of ``benchmark/reference/uni_moe.py``) on the CPU, at a tiny size of
the same shape: a Whisper tower of 2 layers at width 128 over a whole
window, a language model of 2 layers with GQA at 7 query heads to a KV
head, 4 routed experts, a null and 2 shared, top-p 0.7 capped at 2, a
vocabulary of 1024 ids. Also the router on hand-made probabilities, the
grouped expert FFN and its dispatch plan, left padding, the batcher's
path, the refusals, the routing counters, and the Whisper prompt the
engine's new method builds.

Tolerances, against the float32 reference:

* float32: the tower's dynamic int8 rounds each activation row to 8 bits
  in both, from float32 values summed in different orders, so a few
  values round to the neighbouring step; the audio states move by up to
  0.3% of their range and the logits (scale ~4) by ~1.3e-3: ``TOL_F32``
  5e-3. A routing decision may differ only within ``DELTA_F32`` of a
  boundary (seen: 4e-4).
* bfloat16: 8 bits of mantissa at every product and in the residual
  stream; the logits move by ~0.05: ``TOL_BF16`` 0.15, and decisions
  differ within ``DELTA_BF16`` (seen: 0.0065; 0.05, below the benchmark's
  ``DELTA``, which is read off the card at the published widths).
"""

import os

import numpy as np
import pytest
import torch

import plain_uni_moe as ref
from nobs_whisper_torch.core.config import uni_moe_config_from_hparams

TOL_F32, TOL_BF16 = 5e-3, 0.15
DELTA_F32, DELTA_BF16 = 0.005, 0.05
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(
    name="tiny-unimoe", hidden_size=112, num_attention_heads=7,
    num_key_value_heads=1, num_hidden_layers=2, vocab_size=1024,
    mlp_dynamic_expert_num=4, mlp_dynamic_null_expert_num=1,
    dynamic_intermediate_size=96, mlp_fixed_expert_num=2,
    shared_intermediate_size=32, mlp_dynamic_top_p=0.7, mlp_dynamic_top_k=2,
    rope_theta=1e6, rms_norm_eps=1e-6, whisper_query_tokens_size=200,
    endoftext=1000,
    tower=dict(d_model=128, encoder_layers=2, encoder_attention_heads=2,
               encoder_ffn_dim=512, num_mel_bins=128,
               max_source_positions=1500))
VOCAB = [bytes([i]) for i in range(256)] + [
    bytes([97 + i % 26, 97 + (i // 26) % 26]) for i in range(744)]


def _cfg():
    return uni_moe_config_from_hparams(MODEL)


@pytest.fixture(scope="module")
def tiny():
    """The program (tower int8) at f32 and bf16, and the reference over
    the f32 weights."""
    from nobs_whisper_torch.api import UniMoEEngine
    from nobs_whisper_torch.models import uni_moe
    cfg = _cfg()
    p32 = uni_moe.init_params(3, cfg, dtype=torch.float32)
    eng = {dt: UniMoEEngine(params=uni_moe.init_params(3, cfg, dtype=dt),
                            cfg=cfg, tokenizer=_tok(cfg), compute_dtype=dt,
                            device=torch.device("cpu")).quantize()
           for dt in (torch.float32, torch.bfloat16)}
    tree = {k: v for k, v in p32.items() if k != "layers"}
    return eng, ref.Reference(tree, MODEL, lambda i: p32["layers"][i])


def _tok(cfg):
    from nobs_whisper_torch.core.tokenizer import UniMoETokenizer
    return UniMoETokenizer(VOCAB, cfg)


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(16000 * seconds) * 0.1).astype(np.float32)


def _program_logits(eng, audios, prompts, fed):
    """Prefill, then the ``fed`` tokens (B, n) through the cache: logits
    (B, n + 1, V) f32 and the routing (layers, B, T, 2)."""
    from nobs_whisper_torch.audio.mel import (frame_window_np,
                                              log_mel_from_frames)
    from nobs_whisper_torch.decode.greedy import pad_prompts
    from nobs_whisper_torch.models import uni_moe
    from nobs_whisper_torch.models.whisper import encode
    cfg, dt = eng.cfg, eng.compute_dtype
    frames = torch.stack([torch.from_numpy(frame_window_np(a, n_frames=3000))
                          for a in audios])
    mel = log_mel_from_frames(frames, n_mels=128, n_frames=3000)
    toks, pads = pad_prompts(prompts, cfg.eot)
    toks = torch.as_tensor(toks, dtype=torch.long)
    pads = torch.as_tensor(pads, dtype=torch.long)
    b, p_max = toks.shape
    n = fed.shape[1]
    with torch.inference_mode():
        audio = uni_moe.connector(eng.params, encode(eng.params, mel,
                                                     cfg.tower, dt), cfg)
        cache = uni_moe.init_cache(cfg, b, p_max + n + 1, dt, "cpu")
        routing = torch.full((cfg.n_layer, b, p_max + n + 1, 2), -1,
                             dtype=torch.int8)
        out = [uni_moe.lm_forward(eng.params, toks, audio, 0, pads, cache,
                                  cfg, routing).float()]
        for k in range(n):
            out.append(uni_moe.lm_forward(
                eng.params, torch.as_tensor(fed[:, k:k + 1]), None,
                torch.tensor(p_max + k), pads, cache, cfg, routing).float())
    return torch.stack(out, 1), routing, pads.numpy(), p_max


def _reference(r, audios, rows):
    mel = torch.from_numpy(np.stack([ref.log_mel(a, 128) for a in audios]))
    aud = r.audio(r.encode(mel))
    for row, a in zip(rows, aud):
        row["audio"] = a
    return r.run(rows)


def _same_decisions(prog, own):
    """(layers, S) bool: the program's and the reference's expert sets
    equal."""
    out = np.empty(own.shape[:2], bool)
    for i in np.ndindex(*own.shape[:2]):
        out[i] = set(prog[i]) - {-1} == set(own[i]) - {-1}
    return out


@pytest.mark.parametrize("dtype,tol,delta", [
    (torch.float32, TOL_F32, DELTA_F32),
    (torch.bfloat16, TOL_BF16, DELTA_BF16)])
def test_prefill_and_decode_match_the_reference(tiny, dtype, tol, delta):
    """Prefill, then decoding through the cache, against the reference's
    full forward pass over the same tokens, with the program's routing
    applied: logits within the tolerance; the reference's own decisions
    equal the program's outside the ties."""
    engines, r = tiny
    eng = engines[dtype]
    enc = eng.tokenizer.encode
    audios = [_audio(3, 1), _audio(9, 2)]
    prompts = [ref.prompt_ids(enc, MODEL, "", ctx)
               for ctx in ("ab", " ".join(["abc"] * 30))]
    fed = np.random.default_rng(0).integers(0, 1000, (2, 6))
    lg, routing, pads, p_max = _program_logits(eng, audios, prompts, fed)
    rows = [dict(tokens=p + list(f), lo=len(p) - 1,
                 decisions=routing[:, i, pads[i]:p_max + 6].numpy())
            for i, (p, f) in enumerate(zip(prompts, fed))]
    got = _reference(r, audios, rows)
    for i, g in enumerate(got):
        assert (lg[i] - g["logits"]).abs().max().item() <= tol
        same = _same_decisions(rows[i]["decisions"], g["ids"])
        assert not (~same & (g["margin"] > delta)).any()


def _route(p, real=None):
    from nobs_whisper_torch.ops.moe import route
    p = torch.tensor(p, dtype=torch.float64)
    x = torch.eye(p.shape[0])
    return route(x, torch.log(p).float(), 0.7, 2, 4, real)


@pytest.mark.parametrize("p,ids,w", [
    ([0.75, 0.1, 0.05, 0.05, 0.05], [0, -1], [0.75, 0.0]),      # p1 >= 0.7
    ([0.1, 0.72, 0.08, 0.05, 0.05], [1, -1], [0.72, 0.0]),
    ([0.4, 0.1, 0.1, 0.1, 0.3], [0, 4], [0.4, 0.0]),            # null adds 0
    ([0.05, 0.05, 0.05, 0.05, 0.8], [4, -1], [0.0, 0.0]),        # null alone
    ([0.3, 0.25, 0.2, 0.15, 0.1], [0, 1], [0.3, 0.25]),          # cap at 2
    ([0.1, 0.2, 0.35, 0.05, 0.3], [2, 4], [0.35, 0.0]),          # no renorm
])
def test_router_on_hand_made_probabilities(p, ids, w):
    got_ids, got_w = _route([p])
    assert got_ids.tolist() == [ids]
    assert got_w.dtype == torch.float32
    np.testing.assert_allclose(got_w.numpy()[0], w, rtol=1e-6, atol=1e-7)


def test_router_skips_pads_and_gates_in_f32():
    from nobs_whisper_torch.ops.moe import route
    ids, w = _route([[0.75, 0.1, 0.05, 0.05, 0.05]] * 2,
                    real=torch.tensor([True, False]))
    assert ids.tolist() == [[0, -1], [-1, -1]] and w[1].tolist() == [0, 0]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 112), generator=g).to(torch.bfloat16)
    gate = torch.randn((112, 5), generator=g) * 112 ** -0.5
    a, b = route(x, gate, 0.7, 2, 4), route(x.float(), gate, 0.7, 2, 4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_grouped_ffn_and_its_plan_against_a_loop():
    """The plain grouped FFN against a loop over experts on the routed
    pairs; the plan's rows are the routed non-null pairs, each once, every
    block's rows one expert's."""
    from nobs_whisper_torch.ops import moe
    g = torch.Generator().manual_seed(1)
    t, d, f = 40, 112, 96
    x = torch.randn((t, d), generator=g)
    ids, w = moe.route(x, torch.randn((d, 5), generator=g) * d ** -0.5,
                       0.7, 2, 4)
    w13 = torch.randn((4, d, 2 * f), generator=g) * d ** -0.5
    w2 = torch.randn((4, f, d), generator=g) * f ** -0.5
    got = moe.expert_ffn(x, ids, w, w13, w2)
    want = torch.zeros((t, d))
    for e in range(4):
        for tok, slot in (ids == e).nonzero().tolist():
            h = torch.nn.functional.silu(x[tok] @ w13[e, :, :f]) \
                * (x[tok] @ w13[e, :, f:])
            want[tok] += (h @ w2[e]) * w[tok, slot]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    pl = moe.plan(ids, 4, 16)
    rows = pl.rows.view(-1, 16)
    real = rows[rows < pl.n_pairs]
    flat = ids.reshape(-1)
    assert sorted(real.tolist()) == ((flat >= 0) & (flat < 4)).nonzero()[
        :, 0].tolist()
    for b, e in enumerate(pl.block_expert.tolist()):
        r = rows[b][rows[b] < pl.n_pairs]
        assert (e < 0) == (r.numel() == 0)
        if e >= 0:
            assert (flat[r.long()] == e).all()


def test_left_padding_changes_no_row(tiny):
    """A row's tokens do not depend on its pad length or its neighbours:
    decoded alone, and left-padded beside a longer prompt, through the
    window program; its logits through the cache agree within the f32
    tolerance (the tower's int8 rounding is what a batch's other shapes
    move)."""
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.decode.greedy import pad_prompts
    from nobs_whisper_torch.models import uni_moe
    engines, _ = tiny
    eng = engines[torch.float32]
    enc = eng.tokenizer.encode
    short = ref.prompt_ids(enc, MODEL, "", "ab")
    long_ = ref.prompt_ids(enc, MODEL, "", " ".join(["abc"] * 40))
    a, b = _audio(4, 5), _audio(6, 6)
    fed = np.array([[5, 6, 7], [8, 9, 10]])
    alone, _, pads1, _ = _program_logits(eng, [a], [short], fed[:1])
    both, _, pads2, _ = _program_logits(eng, [a, b], [short, long_], fed)
    assert pads2[0] > pads1[0]
    torch.testing.assert_close(both[0], alone[0], rtol=0, atol=TOL_F32)
    tokens = []
    for audios, prompts in (([a], [short]), ([a, b], [short, long_])):
        toks, pads = pad_prompts(prompts, eng.cfg.eot)
        frames = torch.stack([torch.from_numpy(frame_window_np(
            x, n_frames=3000)) for x in audios])
        tokens.append(uni_moe.window_impl(
            eng.params, frames, torch.as_tensor(toks, dtype=torch.long),
            torch.as_tensor(pads, dtype=torch.long), eng.cfg, 8,
            torch.float32)[0][0])
    assert torch.equal(tokens[0], tokens[1])


def test_batched_engine_serves_the_reference_greedy(tiny):
    """``BatchedEngine.transcribe`` through the window batcher on the CPU:
    its prompt ids are the reference template's, and each served token is
    the reference's greedy choice under the program's routing, within the
    f32 tolerance; the routing and the batch's expert counts are kept."""
    from concurrent.futures import ThreadPoolExecutor

    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    engines, r = tiny
    eng = engines[torch.float32]
    be = BatchedEngine(eng, opts=DecodeOptions(
        language="en", temperature_increment=0.0, sample_len=8),
        max_batch=2, max_wait_ms=2000.0)
    sent = []
    submit = be.batcher.submit

    def captured(mel, prompt, **kw):
        sent.append(list(prompt))
        return submit(mel, prompt, **kw)
    be.batcher.submit = captured
    audios = [_audio(3, 7), _audio(8, 8)]
    ctx = ["ab cd", "the end of it"]
    try:
        with ThreadPoolExecutor(2) as ex:
            res = list(ex.map(lambda i: be.transcribe(
                audios[i], language="en", context=ctx[i]), range(2)))
    finally:
        be.close()
    assert be.batcher.batch_sizes == [2]
    rec = GLOBAL_PROFILER.batch_records()[-1]
    tokens, rows, n_routed = rec.experts
    assert n_routed == 4 and rows.shape == (8, 2, 5)
    kept = {(p, s): rt for p, s, rt in GLOBAL_PROFILER.routing_records()}
    rows_in = []
    for i, out in enumerate(res):
        prompt = ref.prompt_ids(eng.tokenizer.encode, MODEL, "", ctx[i])
        assert prompt in sent
        served = out.segments[0].tokens if out.segments else []
        assert len(served) == 8
        rows_in.append(dict(tokens=prompt + served[:-1], lo=len(prompt) - 1,
                            decisions=kept[(tuple(prompt), tuple(served))]))
    assert tokens[0] == sum(len(x["tokens"]) - 7 for x in rows_in)
    for row, g, out in zip(rows_in, _reference(r, audios, rows_in), res):
        lg = g["logits"].numpy()
        served = out.segments[0].tokens
        gaps = lg.max(1) - lg[np.arange(len(served)), served]
        assert gaps.max() <= TOL_F32


@pytest.mark.parametrize("opts,kw", [
    (dict(beam_size=5), {}), (dict(speculative=3), {}),
    (dict(word_timestamps=True), {}), (dict(temperature_increment=0.2), {}),
    (dict(best_of=2), {}), (dict(task="translate"), {}),
    ({}, dict(mesh=object())), ({}, dict(speculative=2))])
def test_what_the_speech_lm_refuses(tiny, opts, kw):
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    engines, _ = tiny
    o = DecodeOptions(**{"language": "en", "temperature_increment": 0.0,
                         **opts})
    with pytest.raises(ValueError, match="not served with"):
        BatchedEngine(engines[torch.float32], opts=o, **kw)


@pytest.mark.parametrize("case", ["auto-language", "long-form", "options"])
def test_what_a_request_to_the_speech_lm_refuses(tiny, case):
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    engines, _ = tiny
    o = DecodeOptions(language="en", temperature_increment=0.0, sample_len=4)
    be = BatchedEngine(engines[torch.float32], opts=o, max_batch=1)
    try:
        with pytest.raises(ValueError):
            if case == "auto-language":
                be.transcribe(_audio(2, 0), language="auto")
            elif case == "long-form":
                be.transcribe(_audio(31, 0), language="en")
            else:
                be.transcribe(_audio(2, 0), language="en",
                              opts=DecodeOptions(language="en",
                                                 word_timestamps=True))
    finally:
        be.close()


def _old_prompt(engine, language, vocabulary, context, task):
    """``BatchedEngine.transcribe``'s inline construction before it moved
    into ``WhisperEngine.window_prompt``."""
    cfg = engine.cfg
    lang = language if language not in (None, "auto") else None
    prompt = []
    initial = engine.build_initial_prompt(vocabulary, context)
    if initial:
        prompt.append(cfg.sot_prev)
        prompt.extend(initial[-(cfg.n_text_ctx // 2 - 1):])
    sot_pos = len(prompt)
    prompt.extend(engine.tokenizer.sot_sequence(
        language=(lang or "en") if cfg.multilingual else None, task=task))
    lang_slot = sot_pos + 1 if lang is None and cfg.multilingual else None
    return prompt, lang_slot


@pytest.mark.parametrize("model", ["tiny", "tiny.en"])
@pytest.mark.parametrize("language,vocabulary,context,task", [
    ("en", None, None, "transcribe"),
    (None, None, None, "transcribe"),
    ("auto", "names", None, "transcribe"),
    ("de", "kubernetes grafana", "the last words we said",
     "translate"),
    ("en", None, " ".join(["word"] * 400), "transcribe"),
    ("fr", "  ", "  context  ", "transcribe"),
])
def test_whisper_window_prompt_as_before(model, language, vocabulary,
                                         context, task):
    from nobs_whisper_torch.api import WhisperEngine
    eng = _whisper(model)
    lang = language if language not in (None, "auto") else None
    assert eng.window_prompt(lang, vocabulary, context, task) == _old_prompt(
        eng, language, vocabulary, context, task)
    assert isinstance(eng, WhisperEngine)


_WHISPER = {}


def _whisper(model):
    from nobs_whisper_torch.api import WhisperEngine
    if model not in _WHISPER:
        _WHISPER[model] = WhisperEngine.from_random(model, dtype=torch.float32,
                                                    device="cpu")
    return _WHISPER[model]


def test_pad_ladder_as_before_up_to_256():
    from nobs_whisper_torch.decode.greedy import _pad_len
    assert [_pad_len(n) for n in (1, 8, 9, 32, 33, 64, 65, 128, 129, 256)] \
        == [8, 8, 32, 32, 64, 64, 128, 128, 256, 256]
    assert [_pad_len(n) for n in (257, 320, 321, 410)] == [320, 320, 384,
                                                          448]


def test_routing_counts_and_summary():
    from nobs_whisper_torch.utils.profiling import (BatchRecord, RoutingTrace,
                                                    expert_summary)
    # 1 layer, 2 rows, p_max 3 (row 0 padded by 1), two decode columns
    host = np.full((1, 2, 6, 2), -1, np.int8)
    host[0, 0, 1:3] = [[0, 4], [1, -1]]
    host[0, 1, 0:3] = [[0, 1], [0, -1], [4, -1]]
    host[0, :, 3] = [[2, -1], [2, 3]]
    host[0, :, 4] = [[4, -1], [1, 0]]
    tr = RoutingTrace(None, np.array([1, 0]), 3, 4, 5)
    tokens, rows, n_routed = tr.counts(host)
    assert tokens.tolist() == [5, 2, 2] and n_routed == 4
    assert rows[:, 0].tolist() == [[3, 2, 0, 0, 2], [0, 0, 2, 1, 0],
                                   [1, 1, 0, 0, 1]]
    assert tr.row(host, 0, 2).shape == (1, 3, 2)
    rec = BatchRecord([], 0, False)
    rec.experts = (tokens, rows, n_routed)
    s = expert_summary([rec])
    assert s["routed_rows"] == pytest.approx((5 + 3 + 2) / 3)
    assert s["experts_hit"] == pytest.approx((2 + 2 + 2) / 3)
    assert s["null_share"] == pytest.approx(3 / 13)
    assert s["slots_per_token"] == pytest.approx(10 / 9)
    assert s["busiest_over_mean"] == pytest.approx(
        np.mean([3 / 2.5, 2 / 1.5, 1.0]))


def test_the_window_prompt_is_the_reference_template():
    tok = _tok(_cfg())
    for voc, ctx in (("", ""), ("names here", "the end"), (None, "ab")):
        assert tok.window_prompt(voc, ctx) == ref.prompt_ids(
            tok.encode, MODEL, voc, ctx)


def test_the_two_reference_copies_are_the_same():
    with open(os.path.join(ROOT, "benchmark", "reference", "uni_moe.py"),
              "rb") as a, open(os.path.join(ROOT, "tests",
                                            "plain_uni_moe.py"), "rb") as b:
        assert a.read() == b.read()
