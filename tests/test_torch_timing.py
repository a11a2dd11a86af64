"""Word-level timestamps on the port, on the CPU: each case of
``tests/test_timing.py`` (DTW, the median filter, word splitting, the
duration and segment refinements, punctuation merging, the end-to-end
long-form words, the alignment heads), and the port against the JAX
package at f32: the alignment scores within 1e-5, and the word texts,
tokens and boundaries equal, window by window and through ``transcribe``.

The reference's word timing raises a ``TypeError`` on an int8 engine (its
teacher-forced pass multiplies by the weights with a plain ``@``, and a
quantized weight is a ``{"q", "s"}`` dict), which is ``serve``'s default;
the port runs it, and its words equal the JAX package's on the same
weights dequantized to f32 float params.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nobs_whisper_torch.decode.timing import (
    WordTiming, decoder_cross_attn_weights, default_alignment_heads,
    dtw_path, find_word_timings, median_filter, merge_punctuations,
    refine_segments_with_words, refine_word_durations,
    split_tokens_on_spaces)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_dtw_identity_diagonal():
    n = 8
    cost = np.ones((n, n)) - np.eye(n)   # cheap diagonal
    ti, fi = dtw_path(cost)
    diag = set(zip(ti.tolist(), fi.tolist()))
    for i in range(n):
        assert (i, i) in diag


def test_dtw_monotonic():
    rng = np.random.RandomState(0)
    ti, fi = dtw_path(rng.rand(10, 30))
    assert (np.diff(ti) >= 0).all() and (np.diff(fi) >= 0).all()
    assert ti[0] == 0 and fi[0] == 0
    assert ti[-1] == 9 and fi[-1] == 29


def test_dtw_prefers_low_cost_band():
    """Tokens 0..3 aligned to frame bands [0-9],[10-19],[20-29],[30-39]."""
    cost = np.ones((4, 40))
    for t in range(4):
        cost[t, t * 10:(t + 1) * 10] = 0.0
    ti, fi = dtw_path(cost)
    starts = {t: fi[np.argmax(ti == t)] for t in range(4)}
    for t in range(4):
        assert t * 10 <= starts[t] < (t + 1) * 10 + 1


@pytest.mark.parametrize("n, m", [(1, 1), (1, 17), (9, 1), (23, 57),
                                  (64, 301), (100, 1500)])
def test_dtw_matches_reference_and_scalar_dp(n, m):
    """The port's DTW path equals the JAX package's and the classic scalar
    dp (``tests/test_timing.py::_dtw_path_scalar``) on the same costs,
    ties included: the tie order is part of the result."""
    from nobs_whisper_tpu.decode.timing import dtw_path as ref_dtw
    from test_timing import _dtw_path_scalar
    cost = -np.random.RandomState(n * 1000 + m).rand(n, m)
    cost[:, ::7] = cost[:, :1]           # tied columns
    got = dtw_path(cost)
    for want in (ref_dtw(cost), _dtw_path_scalar(cost)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_dtw_vectorized_speedup():
    """The serving shape, ~100 tokens x 1500 frames: the vectorized sweep
    beats the interpreted dp by at least 10x."""
    import time
    from test_timing import _dtw_path_scalar
    cost = -np.random.RandomState(8).rand(100, 1500)
    t0 = time.perf_counter()
    dtw_path(cost)
    t_vec = time.perf_counter() - t0
    t0 = time.perf_counter()
    _dtw_path_scalar(cost)
    t_scalar = time.perf_counter() - t0
    assert t_scalar / max(t_vec, 1e-9) >= 10, (t_scalar, t_vec)


def test_median_filter():
    from nobs_whisper_tpu.decode.timing import median_filter as ref_mf
    x = np.array([[1.0, 9.0, 1.0, 1.0, 9.0, 1.0, 1.0]])
    f = median_filter(x, 3)
    assert f.shape == x.shape and f[0, 1] == 1.0   # spikes removed
    np.testing.assert_array_equal(median_filter(x, 1), x)
    y = np.random.RandomState(1).randn(3, 5, 40)
    np.testing.assert_array_equal(median_filter(y, 7), ref_mf(y, 7))


def test_merge_punctuations():
    words = [WordTiming(" hello", 0.0, 0.5, [1], 1.0),
             WordTiming(",", 0.5, 0.6, [2], 1.0),
             WordTiming(" world", 0.6, 1.0, [3], 1.0)]
    merge_punctuations(words)
    assert [w.word for w in words] == [" hello,", " world"]
    assert words[0].end == 0.6 and words[0].tokens == [1, 2]
    words = [WordTiming(" (", 0.0, 0.1, [1], 1.0),
             WordTiming(" a", 0.1, 0.5, [2], 1.0)]
    merge_punctuations(words)
    assert [(w.word, w.start, w.tokens) for w in words] == \
        [(" ( a", 0.0, [1, 2])]


def test_refine_word_durations_clamps_outliers():
    # a leading pause absorbed into the first word: truncated from its end
    words = [WordTiming(" hello", 0.0, 3.0, [1], 1.0),
             WordTiming(" there", 3.0, 3.5, [2], 1.0),
             WordTiming(".", 3.5, 4.0, [3], 1.0),
             WordTiming(" next", 4.0, 4.5, [4], 1.0)]
    refine_word_durations(words)
    assert words[0].end == 3.0
    assert words[0].start == pytest.approx(3.0 - 2 * 0.5)
    # a sentence-end mark smeared across a pause: clamped at its start
    words = [WordTiming(" a", 0.0, 0.5, [1], 1.0),
             WordTiming(" b", 0.5, 1.0, [2], 1.0),
             WordTiming(".", 1.0, 9.0, [3], 1.0),
             WordTiming(" c", 9.0, 9.5, [4], 1.0)]
    refine_word_durations(words)
    assert words[2].end == pytest.approx(1.0 + 2 * 0.5)
    # the word after a sentence end that absorbed the pause: from its end
    words = [WordTiming(" a", 0.0, 0.5, [1], 1.0),
             WordTiming(".", 0.5, 1.0, [2], 1.0),
             WordTiming(" b", 1.0, 9.0, [3], 1.0),
             WordTiming(" c", 9.0, 9.5, [4], 1.0)]
    refine_word_durations(words)
    assert words[2].start == pytest.approx(9.0 - 2 * 0.5)


def test_refine_segments_with_words_snaps_bounds():
    def seg(start, end, words=None):
        return types.SimpleNamespace(start=start, end=end, words=words)

    s1 = seg(0.0, 5.0, [WordTiming(" a", 0.8, 1.2, [1], 1.0),
                        WordTiming(" b", 1.2, 2.1, [2], 1.0)])
    s2 = seg(5.0, 10.0, [WordTiming(" c", 1.9, 6.0, [3], 1.0)])
    s3 = seg(10.0, 12.0, None)        # no words: bounds untouched
    refine_segments_with_words([s1, s2, s3], [], window_end=30.0)
    assert s1.start == 0.8 and s1.end == 2.1
    # monotonic: s2's word starts before s1's refined end, so it clamps
    assert s2.start == pytest.approx(2.1) and s2.end == 6.0
    assert s3.start == 10.0 and s3.end == 12.0


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    return (JaxEngine.from_ggml(path, dtype=jnp.float32),
            WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu"))


@pytest.fixture(scope="module")
def window(engines):
    """One random mel window's encoder states (the JAX package's, shared
    by both packages), a text and the English sot sequence."""
    from nobs_whisper_tpu.models.whisper import encode
    ref, eng = engines
    cfg = eng.cfg
    mel = np.random.RandomState(0).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)
    xa = np.array(encode(ref.params, jnp.asarray(mel), ref.cfg))
    return types.SimpleNamespace(
        xa=xa, text=eng.tokenizer.encode("the thing works here"),
        sot=eng.tokenizer.sot_sequence(language="en"))


def _words(ws):
    return [(w.word, w.tokens) for w in ws], \
        np.array([(w.start, w.end) for w in ws])


def test_longform_word_timestamps_refined(engines):
    """End to end through ``transcribe``: word-anchored, monotonic segment
    bounds inside the window, and the JAX package's words and segments
    (ladder off: its sampled rungs differ across frameworks)."""
    from nobs_whisper_tpu.decode.rules import DecodeOptions as RefOptions
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref, eng = engines
    audio = speech_like_audio(0.6, seed=21)
    r = eng.transcribe(audio, language="en", opts=DecodeOptions(
        word_timestamps=True, temperature_increment=0.0))
    want = ref.transcribe(audio, language="en", opts=RefOptions(
        word_timestamps=True, temperature_increment=0.0))
    assert any(s.words for s in r.segments)
    for s in r.segments:
        assert s.start <= s.end
        if s.words:
            assert s.start == pytest.approx(s.words[0].start, abs=1e-6)
            assert s.end == pytest.approx(max(s.words[-1].end,
                                              s.words[0].start), abs=1e-6)
    for a, b in zip(r.segments, r.segments[1:]):
        assert b.start >= a.start - 1e-6
    assert r.text == want.text and len(r.segments) == len(want.segments)
    for g, w in zip(r.segments, want.segments):
        assert (g.tokens, _words(g.words)[0]) == (w.tokens,
                                                  _words(w.words)[0])
        np.testing.assert_allclose(_words(g.words)[1], _words(w.words)[1],
                                   atol=1e-6)
        assert (g.start, g.end) == pytest.approx((w.start, w.end), abs=1e-6)


def test_split_tokens_on_spaces(engines):
    from nobs_whisper_tpu.decode.timing import \
        split_tokens_on_spaces as ref_split
    ref, eng = engines
    ids = eng.tokenizer.encode("hello world again")
    words, word_toks = split_tokens_on_spaces(eng.tokenizer, ids)
    assert words == ["hello", " world", " again"]
    assert [t for ts in word_toks for t in ts] == ids
    assert (words, word_toks) == ref_split(ref.tokenizer, ids)


def test_find_word_timings_monotonic(engines, window):
    """Words inside the window and in order; equal to the JAX package's
    (texts, tokens, bounds) on the same encoder states."""
    from nobs_whisper_tpu.decode.timing import \
        find_word_timings as ref_find
    ref, eng = engines
    cfg = eng.cfg
    words = find_word_timings(eng.params, cfg, eng.tokenizer,
                              torch.from_numpy(window.xa), window.text,
                              window.sot, num_frames=2 * cfg.n_audio_ctx)
    assert len(words) >= 1
    window_s = 2 * cfg.n_audio_ctx / 100
    for w in words:
        assert 0.0 <= w.start <= w.end <= window_s + 1e-6
    for a, b in zip(words, words[1:]):
        assert b.start >= a.start - 1e-6
    want = ref_find(ref.params, ref.cfg, ref.tokenizer,
                    jnp.asarray(window.xa), window.text, window.sot,
                    num_frames=2 * cfg.n_audio_ctx)
    assert _words(words)[0] == _words(want)[0]
    np.testing.assert_allclose(_words(words)[1], _words(want)[1], atol=1e-6)


@pytest.mark.parametrize("heads", [None, ((1, 0), (1, 2), (0, 3))])
def test_alignment_scores_match_reference(engines, window, heads):
    """The teacher-forced pass's selected raw scores equal the JAX
    package's within 1e-5 at f32 (the default heads and a tuned list)."""
    from nobs_whisper_tpu.decode.timing import alignment_scores_jit
    from nobs_whisper_torch.decode.timing import alignment_scores
    ref, eng = engines
    cfg = eng.cfg
    heads = heads or tuple(default_alignment_heads(cfg))
    toks = np.array([list(window.sot) + window.text + [cfg.eot]])
    got = alignment_scores(eng.params, torch.from_numpy(toks),
                           torch.from_numpy(window.xa), cfg, heads)
    want = alignment_scores_jit(ref.params, jnp.asarray(toks),
                                jnp.asarray(window.xa), ref.cfg, heads)
    assert got.shape == (len(heads), toks.shape[1], cfg.n_audio_ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cross_attn_weights_shape(engines, window):
    from nobs_whisper_tpu.decode.timing import \
        decoder_cross_attn_weights as ref_weights
    ref, eng = engines
    cfg = eng.cfg
    toks = np.array([[cfg.sot, 5, 6, cfg.eot]])
    probs = decoder_cross_attn_weights(eng.params, torch.from_numpy(toks),
                                       torch.from_numpy(window.xa), cfg)
    assert probs.shape == (cfg.n_text_layer, 1, cfg.n_text_head, 4,
                           cfg.n_audio_ctx)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=1e-4)
    np.testing.assert_allclose(
        probs.numpy(), np.asarray(ref_weights(
            ref.params, jnp.asarray(toks), jnp.asarray(window.xa),
            ref.cfg)), atol=1e-6)


def test_default_alignment_heads(engines):
    from nobs_whisper_tpu.decode.timing import \
        default_alignment_heads as ref_heads
    _, eng = engines
    cfg = eng.cfg
    heads = default_alignment_heads(cfg)
    assert all(l >= cfg.n_text_layer // 2 for l, _ in heads)
    assert len(heads) == (cfg.n_text_layer - cfg.n_text_layer // 2) * \
        cfg.n_text_head
    assert heads == ref_heads(cfg)


def test_alignment_heads_from_checkpoint_metadata(tmp_path, monkeypatch):
    """Tuned DTW heads flow from a GGML sidecar into the engine and from
    there into ``transcribe``'s words (a malformed sidecar is ignored)."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.utils.testing import (speech_like_audio,
                                                  write_tiny_checkpoint)
    path = str(tmp_path / "m.bin")
    write_tiny_checkpoint(path)
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    assert eng.alignment_heads is None
    with open(str(tmp_path / "m.alignment_heads.json"), "w") as f:
        json.dump([[1, 0], [1, 2]], f)
    tuned = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    assert tuned.alignment_heads == [(1, 0), (1, 2)]
    seen = []
    import nobs_whisper_torch.decode.timing as tm
    real = tm.alignment_scores

    def spy(params, tokens, xa, cfg, heads, *a):
        seen.append(heads)
        return real(params, tokens, xa, cfg, heads, *a)

    monkeypatch.setattr(tm, "alignment_scores", spy)
    tuned.transcribe(speech_like_audio(0.6, seed=21), language="en",
                     opts=DecodeOptions(word_timestamps=True,
                                        temperature_increment=0.0))
    assert seen and all(h == ((1, 0), (1, 2)) for h in seen)
    with open(str(tmp_path / "m.alignment_heads.json"), "w") as f:
        f.write("{broken")
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    assert eng.alignment_heads is None


def _dequantized(tree):
    """The JAX package's params with every int8 weight replaced by its
    f32 dequantization (q * s), the float params it stands for."""
    from nobs_whisper_tpu.ops.quant import is_quantized
    if is_quantized(tree):
        return tree["q"].astype(jnp.float32) * tree["s"].astype(jnp.float32)
    if isinstance(tree, dict):
        return {k: _dequantized(v) for k, v in tree.items()}
    return tree


def test_int8_engine_words_fixed(engines, window):
    """On an int8 engine the reference's word timing raises ``TypeError``
    (a quantized weight is a dict, and its pass multiplies by a plain
    ``@``); the port's words equal the JAX package's run on the same
    weights dequantized to f32 float params."""
    from nobs_whisper_tpu.decode.timing import \
        find_word_timings as ref_find
    ref, eng = engines
    cfg = eng.cfg
    qref, qeng = ref.quantize(), eng.quantize()
    xa = jnp.asarray(window.xa)
    args = (window.text, window.sot)
    with pytest.raises(TypeError):
        ref_find(qref.params, ref.cfg, ref.tokenizer, xa, *args,
                 num_frames=2 * cfg.n_audio_ctx)
    got = find_word_timings(qeng.params, cfg, eng.tokenizer,
                            torch.from_numpy(window.xa), *args,
                            num_frames=2 * cfg.n_audio_ctx)
    jax.clear_caches()
    want = ref_find(_dequantized(qref.params), ref.cfg, ref.tokenizer, xa,
                    *args, num_frames=2 * cfg.n_audio_ctx)
    assert got and _words(got)[0] == _words(want)[0]
    np.testing.assert_allclose(_words(got)[1], _words(want)[1], atol=1e-6)
