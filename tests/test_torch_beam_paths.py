"""The beam strategy through the port's serving paths on the CPU, the
reference's beam checklists on each (``tests/test_batcher.py``,
``test_batched_engine.py``, ``test_cli.py``): the batcher's beam branch
(temperature-0 rows by beam, ladder retries by sampling, each subset at
its own size), fixed-language beam batches without the language-detect
forward, ``BatchedEngine`` with a beam strategy, long-form with beam at
temperature 0, and the CLI (``transcribe --beam-size``,
``_default_beam_batch``, ``serve``'s beam batch). Results are held to the
JAX package's on the same tiny checkpoint: tokens and text exact.
"""

import argparse
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("ckpt") / "ggml-tiny.bin")
    write_tiny_checkpoint(path)
    return path


@pytest.fixture(scope="module")
def engines(tiny_ckpt):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    return (JaxEngine.from_ggml(tiny_ckpt, dtype=jnp.float32),
            WhisperEngine.from_ggml(tiny_ckpt, dtype=torch.float32,
                                    device="cpu"))


def _no_fallback(**kw):
    """Beam options with the ladder off: the rules of both packages."""
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_torch.decode import rules as trl
    return (jr.DecodeOptions(temperature_increment=0.0, **kw),
            trl.DecodeOptions(temperature_increment=0.0, **kw))


def _ref_beam(ref, mel, prompt, beam_size):
    """The JAX package's beam decode of one mel window."""
    from nobs_whisper_tpu.decode.beam import beam_decode_window
    from nobs_whisper_tpu.decode.rules import DecodeOptions, build_rule_tables
    from nobs_whisper_tpu.models.whisper import encode
    xa = encode(ref.params, jnp.asarray(mel[None]), ref.cfg)
    tables = build_rule_tables(ref.cfg, DecodeOptions(), ref.tokenizer)
    return beam_decode_window(ref.params, xa, [prompt], ref.cfg, tables,
                              beam_size=beam_size)[0]


def _batcher(eng, opts, **kw):
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    return WindowBatcher(eng.params, eng.cfg, eng.tokenizer, opts,
                         device="cpu", **kw)


def test_beam_batch_splits_zero_and_hot_rows(engines, monkeypatch):
    """A beam batch of three temperature-0 rows and two ladder retries
    makes one beam call of 3 rows and one sampling call of 2 (the port's
    rule: each subset at its own size; the reference pads both subsets to
    its bounded batch sizes, ``tests/test_batcher.py::
    test_beam_finalizer_pads_subsets``, because a new size compiles a new
    program there). The beam rows equal the reference's beam decode of
    the same windows."""
    import nobs_whisper_torch.decode.beam as beam_mod
    import nobs_whisper_torch.decode.greedy as greedy_mod
    ref, eng = engines
    cfg = eng.cfg
    _, opts = _no_fallback(beam_size=2)
    sizes = {"beam": [], "sample": []}
    orig_beam, orig_greedy = (beam_mod.beam_decode_window,
                              greedy_mod.decode_window)

    def spy_beam(params, xa, prompts, *a, **kw):
        sizes["beam"].append(len(prompts))
        return orig_beam(params, xa, prompts, *a, **kw)

    def spy_greedy(params, xa, prompts, *a, **kw):
        sizes["sample"].append(len(prompts))
        return orig_greedy(params, xa, prompts, *a, **kw)

    monkeypatch.setattr(beam_mod, "beam_decode_window", spy_beam)
    monkeypatch.setattr(greedy_mod, "decode_window", spy_greedy)
    batcher = _batcher(eng, opts, max_batch=8, max_wait_ms=500)
    rng = np.random.RandomState(3)
    mels = [rng.randn(cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)
            for _ in range(5)]
    prompt = eng.tokenizer.sot_sequence(language="en")
    try:
        futs = [batcher.submit(m, prompt, temperature=0.0 if i < 3 else 0.4)
                for i, m in enumerate(mels)]
        res = [f.result(timeout=180) for f in futs]
    finally:
        batcher.close()
    assert batcher.batch_sizes == [5]
    assert sizes == {"beam": [3], "sample": [2]}
    assert [r.temperature for r in res] == pytest.approx([0.0] * 3
                                                         + [0.4] * 2)
    for m, r in zip(mels[:3], res):
        want = _ref_beam(ref, m, prompt, 2)
        assert r.tokens == want.tokens
        assert r.sum_logprob == pytest.approx(want.sum_logprob, rel=1e-4)


@pytest.mark.parametrize("language", ["en", None])
def test_beam_batch_language_detect_only_when_asked(engines, monkeypatch,
                                                    language):
    """A framed beam batch whose rows all pin a language runs the encoder
    without the language-detect forward; an auto-language row runs it
    once and patches its prompt (``tests/test_batcher.py::
    test_fixed_language_beam_batch_skips_detect``)."""
    import nobs_whisper_torch.decode.greedy as g
    from nobs_whisper_torch.audio.mel import frame_window_np
    _, eng = engines
    cfg = eng.cfg
    _, opts = _no_fallback(beam_size=2)
    called = {"detect": 0, "encode_only": 0}
    orig_detect, orig_enc = g.frames_encode_detect_impl, g.frames_encode_impl

    def spy_detect(*a, **kw):
        called["detect"] += 1
        return orig_detect(*a, **kw)

    def spy_enc(*a, **kw):
        called["encode_only"] += 1
        return orig_enc(*a, **kw)

    monkeypatch.setattr(g, "frames_encode_detect_impl", spy_detect)
    monkeypatch.setattr(g, "frames_encode_impl", spy_enc)
    batcher = _batcher(eng, opts, max_batch=4, max_wait_ms=20)
    audio = (np.random.RandomState(5).randn(16000) * 0.2).astype(np.float32)
    frames = frame_window_np(audio, n_frames=2 * cfg.n_audio_ctx)
    prompt = eng.tokenizer.sot_sequence(language="en")
    try:
        res = batcher.submit(None, prompt, frames=frames,
                             lang_slot=None if language else 1
                             ).result(timeout=120)
    finally:
        batcher.close()
    # frames_encode_detect_impl encodes through frames_encode_impl
    assert called == ({"detect": 0, "encode_only": 1} if language
                      else {"detect": 1, "encode_only": 1})
    assert (res.language is None) == bool(language)


def test_beam_strategy_through_batched_engine(engines):
    """``BatchedEngine`` built with a beam strategy (a serve config's
    ``beam_size``) decodes a window through the batcher's beam branch and
    gives the reference's beam result on the same audio
    (``tests/test_batched_engine.py::test_beam_strategy_through_batcher``)."""
    from nobs_whisper_tpu.audio.mel import HOP_LENGTH, log_mel_longform
    from nobs_whisper_torch.decode.hallucination import filter_hallucinations
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref, eng = engines
    cfg = eng.cfg
    _, opts = _no_fallback(beam_size=3)
    beamed = BatchedEngine(eng, opts=opts, max_batch=4, max_wait_ms=20)
    try:
        audio = speech_like_audio(0.5, seed=17)
        b = beamed.transcribe(audio, language="en")
        assert beamed.batcher.batch_sizes == [1]
    finally:
        beamed.close()
    wf = 2 * cfg.n_audio_ctx
    mel = np.asarray(log_mel_longform(audio, n_mels=cfg.n_mels,
                                      padding=wf * HOP_LENGTH)[:, :wf])
    want = _ref_beam(ref, mel, eng.tokenizer.sot_sequence(language="en"), 3)
    assert b.text == filter_hallucinations(
        eng.tokenizer.decode(want.tokens).strip())
    assert [s.tokens for s in b.segments] == ([want.tokens] if b.text else [])


def test_beam_longform_matches_reference(engines):
    """Multi-window audio with beam at temperature 0 and the sampling
    ladder above it (``decode_with_fallback``): the port's sequential
    ``transcribe`` gives the reference's segments, and ``BatchedEngine``'s
    batched long-form (every window's decode through the batcher's beam
    branch) gives the same."""
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref, eng = engines
    jo, to = _no_fallback(beam_size=3)
    audio = speech_like_audio(3.0, seed=23)
    want = ref.transcribe(audio, language="en", opts=jo)
    got = eng.transcribe(audio, language="en", opts=to)
    assert len(got.segments) > 1
    assert [s.tokens for s in got.segments] == \
        [s.tokens for s in want.segments]
    assert got.text == want.text
    beamed = BatchedEngine(eng, opts=to, max_batch=2)
    try:
        bat = beamed.transcribe(audio, language="en")
    finally:
        beamed.close()
    assert [s.tokens for s in bat.segments] == \
        [s.tokens for s in got.segments]


def test_beam_wired_into_transcribe_ladder(engines):
    """beam_size flows through the fallback ladder (``tests/test_cli.py::
    test_beam_wired_into_transcribe``): the gates pass at the first rung,
    so the result is beam's, at temperature 0, as the reference's."""
    ref, eng = engines
    from nobs_whisper_torch.utils.testing import speech_like_audio
    kw = dict(beam_size=3, logprob_threshold=-1e9, entropy_threshold=0.0,
              no_speech_threshold=1.1, compression_ratio_threshold=1e9)
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JOpts
    from nobs_whisper_torch.decode.rules import DecodeOptions
    audio = speech_like_audio(0.5, seed=4)
    got = eng.transcribe(audio, language="en", opts=DecodeOptions(**kw))
    want = ref.transcribe(audio, language="en", opts=JOpts(**kw))
    assert got.text == want.text
    assert all(s.temperature == 0.0 for s in got.segments)


def test_cli_transcribe_beam_size(tiny_ckpt, engines, tmp_path, capsys):
    """``transcribe --beam-size 3`` is served (no longer refused): the
    verb prints the engine's own beam result."""
    from nobs_whisper_torch import cli
    from nobs_whisper_torch.audio.io import load_audio, write_wav
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.utils.testing import speech_like_audio
    _, eng = engines
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speech_like_audio(0.8, seed=2))
    cli.main(["transcribe", wav, "--model", tiny_ckpt, "--device", "cpu",
              "--dtype", "float32", "--language", "en", "--beam-size", "3",
              "--temperature-increment", "0", "--json"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json
    audio, _ = load_audio(wav)
    direct = eng.transcribe(audio, language="en", opts=DecodeOptions(
        beam_size=3, temperature_increment=0.0))
    assert json.loads(out)["text"] == direct.text


def test_default_beam_batch():
    """The beam batch default: about 120 flattened rows over the beam
    width, clamped to the greedy default; the reference's values."""
    from nobs_whisper_tpu.cli import _default_beam_batch as ref
    from nobs_whisper_torch.cli import _default_beam_batch
    cases = [("large-v3-turbo", 5), ("large-v3", 5), ("small", 5),
             ("large-v3-turbo", 2), ("tiny", 10), (None, 200),
             ("/data/smallville/ggml-large-v3.bin", 3)]
    assert [_default_beam_batch(*c) for c in cases] == \
        [ref(*c) for c in cases] == [24, 24, 24, 40, 12, 1, 24]


def test_cmd_serve_uses_beam_batch(tmp_path, monkeypatch):
    """With a configured beam strategy, ``serve``'s automatic batch is the
    beam default (``tests/test_cli.py::test_cmd_serve_uses_beam_knee``),
    and the engine it builds is a ``BatchedEngine`` whose batcher takes
    the beam strategy (no refusal)."""
    from nobs_whisper_torch import cli as climod
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.serve.config import ConfigManager
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))
    ConfigManager().update(beam_size=5)
    seen = {}

    def fake_default_beam(mid, k):
        seen["args"] = (mid, k)
        return 2

    def fake_serve(engine, **kw):
        seen["engine"] = engine

    monkeypatch.setattr(climod, "_default_beam_batch", fake_default_beam)
    monkeypatch.setattr(climod, "_load_engine", lambda *a, **kw:
                        WhisperEngine.from_random("tiny-test", device="cpu",
                                                  dtype=torch.float32))
    monkeypatch.setattr("nobs_whisper_torch.serve.server.serve", fake_serve)
    args = argparse.Namespace(
        model="large-v3-turbo", host="127.0.0.1", port=0, batch=0,
        mesh=None, dtype="float32", quant="none", warmup=False,
        speculative=0, draft_model=None, audio_ctx=0, device="cpu",
        sample_len=0, temperature_increment=None, rss_watermark_mb=0.0)
    climod.cmd_serve(args)
    be = seen["engine"]
    try:
        assert seen["args"] == ("large-v3-turbo", 5)
        assert be.batcher.max_batch == 2 and be.opts.beam_size == 5
    finally:
        be.close()


def test_beam_options_still_refuse_unported(engines):
    """Beside beam, speculative decoding and word timestamps, once refused,
    are served: beam wins over ``speculative`` (the reference batcher
    takes ``use_beam`` first), so the text and tokens are beam's, through
    ``BatchedEngine`` and ``transcribe``; word timestamps keep beam's text
    and add words. Both held to the JAX package's beam text."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import speech_like_audio
    ref, eng = engines
    audio = speech_like_audio(0.5, seed=5)
    ref_opts, beam = _no_fallback(beam_size=5)
    want = ref.transcribe(audio, language="en", opts=ref_opts)

    def batched(opts):
        be = BatchedEngine(eng, opts=opts, max_batch=2)
        try:
            return be.transcribe(audio, language="en")
        finally:
            be.close()

    want_b = batched(beam)
    for kw in (dict(speculative=2), dict(word_timestamps=True)):
        opts = dataclasses.replace(beam, **kw)
        got_b = batched(opts)
        got = eng.transcribe(audio, language="en", opts=opts)
        assert got_b.text == want_b.text and got.text == want.text
        assert [s.tokens for s in got.segments] == \
            [s.tokens for s in want.segments]
        assert [s.tokens for s in got_b.segments] == \
            [s.tokens for s in want_b.segments]
        if "word_timestamps" in kw:
            # words partition the text tokens over the segments
            assert all(s.words is not None for s in got.segments)
            eot = eng.cfg.eot
            assert [t for s in got.segments for w in s.words
                    for t in w.tokens] == [t for s in got.segments
                                           for t in s.tokens if t < eot]
