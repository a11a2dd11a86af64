"""The serving layer of the port against the JAX package's, on the same f32
tiny GGML checkpoint and the same seeded audio: a push-to-talk session
with a vocabulary over several VAD chunks gives the same event sequence
and the same tokens in every partial and the final; the HTTP one-shot
``/transcribe`` gives the same JSON and srt bodies (WAV, raw PCM with a
``sample_rate``). Tokens are held exactly, as the f32 goldens are.

Both sides decode greedily with no temperature-fallback ladder: the
ladder's rungs above 0 sample, and the two packages' random generators
differ by design."""

import dataclasses
import io
import json
import socket
import urllib.request

import pytest
import torch

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

VOCAB = "Kubernetes, pallas, GitHub"
# a segment's f32 scores; every other field is held exactly
SCORES = ("avg_logprob", "compression_ratio", "no_speech_prob")


@pytest.fixture(autouse=True)
def isolated_home(tmp_path, monkeypatch):
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("ckpt") / "ggml-tiny.bin")
    write_tiny_checkpoint(path, seed=5)
    return path


@pytest.fixture(scope="module")
def engines(ckpt):
    import jax.numpy as jnp
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_tpu.api import WhisperEngine as RefEngine
    return (RefEngine.from_ggml(ckpt, dtype=jnp.float32),
            WhisperEngine.from_ggml(ckpt, dtype=torch.float32,
                                    device="cpu"))


class Recorded:
    """The engine surface a session or server calls, recording each
    result in call order, with ``opts`` pinned to greedy (no fallback
    ladder) as the module docstring says."""

    def __init__(self, engine):
        self.engine = engine
        self.results = []

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def transcribe(self, audio, opts=None, **kw):
        opts = dataclasses.replace(opts, temperature_increment=0.0) \
            if opts is not None else None
        r = self.engine.transcribe(audio, opts=opts, **kw)
        self.results.append(r)
        return r


def test_session_events_and_tokens_match_reference(engines):
    """A 48 kHz session with a vocabulary, pushed in 0.5 s bodies: the
    VAD cuts it into several chunks, each transcribed with the previous
    chunk's text as its prompt, then the residue at stop. Both packages'
    ``BatchedEngine`` (greedy, no ladder) under their own
    ``StreamingSession`` give the same events, and the same tokens in
    every call."""
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.pipeline.session import (SessionConfig,
                                                     StreamingSession)
    from nobs_whisper_torch.utils.testing import speech_like_audio
    from nobs_whisper_tpu.decode.rules import DecodeOptions as RefOptions
    from nobs_whisper_tpu.pipeline.batched_engine import \
        BatchedEngine as RefBatched
    from nobs_whisper_tpu.pipeline.session import (
        SessionConfig as RefConfig, StreamingSession as RefSession)

    ref_eng, eng = engines
    audio = speech_like_audio(15.0, seed=4, sample_rate=48000)
    pushes = [audio[i:i + 24000] for i in range(0, len(audio), 24000)]
    sides = []
    for Batched, Opts, Session, Config, e in (
            (RefBatched, RefOptions, RefSession, RefConfig, ref_eng),
            (BatchedEngine, DecodeOptions, StreamingSession, SessionConfig,
             eng)):
        be = Batched(e, opts=Opts(temperature_increment=0.0), max_batch=2)
        rec, events = Recorded(be), []
        s = Session(rec, Config(language="en", vocabulary=VOCAB,
                                sample_rate=48000), on_event=events.append)
        try:
            assert s.start()
            for p in pushes:
                s.push_audio(p)
            final = s.stop()
        finally:
            be.close()
        sides.append((final, [(ev.state, ev.transcript, ev.is_final)
                              for ev in events],
                      [[seg.tokens for seg in r.segments]
                       for r in rec.results]))
    (ref_final, ref_events, ref_tokens), (final, got_events, tokens) = sides
    assert len(ref_tokens) >= 3          # two VAD chunks and the residue
    partials = [e for e in got_events if e[0] == "partial"]
    assert len(partials) >= 2 and final
    assert got_events == ref_events
    assert tokens == ref_tokens
    assert final == ref_final


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def servers(engines):
    """The JAX package's server on its engine, and the port's on its:
    (base URL, server) each."""
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_tpu.serve.server import serve as ref_serve
    out = []
    for serve_fn, eng in zip((ref_serve, serve), engines):
        port = _free_port()
        out.append((f"http://127.0.0.1:{port}",
                    serve_fn(Recorded(eng), port=port, background=True)))
    yield out
    for _, httpd in out:
        httpd.shutdown()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read().decode("utf-8")


def _wav(audio, rate):
    from nobs_whisper_torch.audio.io import write_wav
    buf = io.BytesIO()
    write_wav(buf, audio, rate)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["wav", "pcm48k", "srt"])
def test_one_shot_bodies_match_reference_server(servers, kind):
    """``/transcribe`` of a 2.5 s clip (two windows of the tiny model)
    with the configured default vocabulary: the JAX package's server and
    the port's give the same text, language and segments (tokens, ids,
    seeks and times exactly; the f32 scores within 1e-5), and the same
    srt body."""
    from nobs_whisper_torch.utils.testing import speech_like_audio
    (ref_base, ref_httpd), (base, httpd) = servers
    if kind == "pcm48k":
        body = speech_like_audio(2.5, seed=8, sample_rate=48000)
        path, body = "/transcribe?language=en&sample_rate=48000", \
            body.astype("<f4").tobytes()
    else:
        path = "/transcribe?language=en" + (
            "&format=srt" if kind == "srt" else "")
        body = _wav(speech_like_audio(2.5, seed=7), 16000)
    want, got = _post(ref_base, path, body), _post(base, path, body)
    ref_calls = ref_httpd.state.engine.results
    calls = httpd.state.engine.results
    assert [[s.tokens for s in r.segments] for r in calls[-1:]] == \
        [[s.tokens for s in r.segments] for r in ref_calls[-1:]]
    if kind == "srt":
        assert got == want and "-->" in got
        return
    want, got = json.loads(want), json.loads(got)
    assert got["text"] == want["text"] and got["text"]
    assert got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"]) > 1
    for g, w in zip(got["segments"], want["segments"]):
        assert set(g) == set(w)
        for k in g:
            if k in SCORES:
                assert g[k] == pytest.approx(w[k], rel=1e-5, abs=1e-5), k
            else:
                assert g[k] == w[k], k
