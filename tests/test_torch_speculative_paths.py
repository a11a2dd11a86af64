"""Exact speculative greedy decoding through the port's serving paths on
the CPU, the serving cases of ``tests/test_speculative.py`` run in both
packages at f32: the batcher (the framed main path and the auto-language
path that decodes from encoder states), the mel-window path and int8
cross-KV through ``decode_window_dispatch``, a second-model draft through
``BatchedEngine``, and ``spec_stats`` in ``/stats``. Each holds the port's
speculative tokens equal to the JAX package's and to the port's own
sequential greedy ones, with equal pass counts. Also the CLI:
``transcribe --speculative --draft-pool`` and ``serve --speculative
--draft-pool --draft-model`` (the draft quantized like the target; an
incompatible draft, a draft without ``--speculative`` and a beam strategy
each turn speculation off with the reference's message).
"""

import argparse
import json
import socket
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    d = tmp_path_factory.mktemp("m")
    target, draft = str(d / "target.bin"), str(d / "draft.bin")
    write_tiny_checkpoint(target, seed=0)
    write_tiny_checkpoint(draft, seed=42)

    def both(path):
        return (JaxEngine.from_ggml(path, dtype=jnp.float32),
                WhisperEngine.from_ggml(path, dtype=torch.float32,
                                        device="cpu"))

    (ref, eng), (ref_draft, eng_draft) = both(target), both(draft)
    return types.SimpleNamespace(ref=ref, eng=eng, ref_draft=ref_draft,
                                 eng_draft=eng_draft, target=target,
                                 draft=draft)


def _assert_rows(seq, spec, ref_spec):
    for a, b, r in zip(seq, spec, ref_spec):
        assert b.tokens == r.tokens == a.tokens
        assert b.sum_logprob == pytest.approx(a.sum_logprob, abs=2e-2)


def test_batcher_speculative_matches_plain(setup):
    """A batcher with speculative=2, draft_pool=2 gives the plain
    batcher's results through the framed main path and the auto-language
    route (which decodes from encoder states), as the JAX package's
    speculative batcher does, and records the same passes."""
    from nobs_whisper_tpu.pipeline.batcher import WindowBatcher as RefBatcher
    from nobs_whisper_torch.audio.mel import frame_window_np
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    s = setup
    cfg = s.eng.cfg
    rng = np.random.RandomState(7)
    frames = [frame_window_np((rng.randn(16000) * 0.2).astype(np.float32),
                              n_frames=2 * cfg.n_audio_ctx) for _ in range(3)]
    prompt = s.eng.tokenizer.sot_sequence(language="en")

    def run(b):
        try:
            out = [b.submit(None, prompt, frames=f).result(timeout=300)
                   for f in frames]
            out.append(b.submit(None, list(prompt), frames=frames[0],
                                lang_slot=1).result(timeout=300))
            return out, b.spec_stats
        finally:
            b.close()

    kw = dict(max_batch=4, max_wait_ms=20)
    base, _ = run(WindowBatcher(s.eng.params, cfg, s.eng.tokenizer,
                                DecodeOptions(), device="cpu", **kw))
    spec, stats = run(WindowBatcher(s.eng.params, cfg, s.eng.tokenizer,
                                    DecodeOptions(), device="cpu",
                                    speculative=2, draft_pool=2, **kw))
    ref, ref_stats = run(RefBatcher(s.ref.params, s.ref.cfg,
                                    s.ref.tokenizer, speculative=2,
                                    draft_pool=2, **kw))
    _assert_rows(base, spec, ref)
    assert [r.language for r in spec] == [r.language for r in ref]
    assert len(stats) == 4 and stats == ref_stats


def test_mel_path_and_q8_speculative_exact(setup):
    """The mel-window path and int8 cross-KV go through the speculative
    program too (no quiet sequential fallback): each equals its own
    sequential decode and the JAX package's, with the JAX package's pass
    count in the handle's sixth element."""
    from nobs_whisper_tpu.decode import greedy as jg
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_tpu.models.whisper import encode
    from nobs_whisper_torch.decode import greedy as tg
    from nobs_whisper_torch.decode import rules as trl
    s = setup
    cfg = s.eng.cfg
    prompts = [list(s.eng.tokenizer.sot_sequence(language="en"))] * 3
    rng = np.random.RandomState(5)
    mel = rng.randn(3, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)
    xa = np.array(encode(s.ref.params, jnp.asarray(
        rng.randn(3, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)),
        s.ref.cfg))
    for q8, kw in ((False, dict(mel=mel)), (True, dict(xa=xa))):
        jo, to = jr.DecodeOptions(q8_cross_kv=q8), trl.DecodeOptions(
            q8_cross_kv=q8)
        jt = jr.build_rule_tables(s.ref.cfg, jo, s.ref.tokenizer)
        tt = trl.build_rule_tables(cfg, to, s.eng.tokenizer)
        src = next(iter(kw.values()))
        tkw = {"mel": torch.from_numpy(src)} if "mel" in kw else {}
        t_xa = torch.from_numpy(src) if "xa" in kw else None

        def port(**extra):
            return tg.decode_window_dispatch(s.eng.params, t_xa, prompts,
                                             cfg, tt, to, **tkw, **extra)
        base = tg.decode_window_finalize(port())
        h = port(speculative=2, draft_pool=2)
        rh = jg.decode_window_dispatch(
            s.ref.params, jnp.asarray(src) if "xa" in kw else None, prompts,
            s.ref.cfg, jt, jo, mel=jnp.asarray(src) if "mel" in kw else None,
            speculative=2, draft_pool=2)
        # the port's handle names its pass count (``WindowHandle.passes``);
        # the reference's is its sixth element
        assert h.passes is not None and len(rh) == 6
        assert int(h.passes) == int(np.asarray(rh[5]))
        _assert_rows(base, tg.decode_window_finalize(h),
                     jg.decode_window_finalize(rh))


def test_second_model_draft_through_serving(setup):
    """``BatchedEngine`` with a second-model draft engine gives the plain
    engine's transcript, as the JAX package's does (the fallback ladder
    off: its sampled rungs draw different numbers in the two frameworks);
    a draft of another vocabulary or encoder width is refused at
    construction."""
    from nobs_whisper_tpu.decode.rules import DecodeOptions as RefOptions
    from nobs_whisper_tpu.pipeline.batched_engine import \
        BatchedEngine as RefBatched
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import (speech_like_audio,
                                                  tiny_test_config)
    s = setup
    audio = np.asarray(speech_like_audio(0.5, seed=41))
    kw = dict(max_batch=2, max_wait_ms=20)
    opts = DecodeOptions(temperature_increment=0.0)
    plain = BatchedEngine(s.eng, opts=opts, **kw)
    spec = BatchedEngine(s.eng, opts=opts, speculative=2,
                         draft_engine=s.eng_draft, **kw)
    ref = RefBatched(s.ref, opts=RefOptions(temperature_increment=0.0),
                     speculative=2, draft_engine=s.ref_draft, **kw)
    try:
        a = plain.transcribe(audio, language="en")
        b = spec.transcribe(audio, language="en")
        r = ref.transcribe(audio, language="en")
        assert a.text == b.text == r.text
        assert spec.batcher.spec_stats == ref.batcher.spec_stats
        assert spec.batcher.spec_stats
    finally:
        for e in (plain, spec, ref):
            e.close()
    bad = types.SimpleNamespace(params=s.eng_draft.params,
                                cfg=tiny_test_config(n_vocab=2048))
    with pytest.raises(ValueError, match="draft model incompatible"):
        BatchedEngine(s.eng, speculative=2, draft_engine=bad)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def test_spec_stats_in_server_stats(setup, tmp_path, monkeypatch):
    """A speculative server reports its acceptance in ``/stats``
    (``speculative.emitted_per_pass``), the JAX package's server the
    same figures for the same request (only the temperature-0 rung is
    speculative, so the figures do not depend on the ladder's sampled
    rungs, which draw different numbers in the two frameworks)."""
    from nobs_whisper_tpu.pipeline.batched_engine import \
        BatchedEngine as RefBatched
    from nobs_whisper_tpu.serve.server import serve as ref_serve
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.serve.server import serve
    from nobs_whisper_torch.utils.testing import speech_like_audio
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))
    s = setup
    audio = np.asarray(speech_like_audio(0.5, seed=43), dtype=np.float32)
    out = []
    for make, srv in ((lambda: BatchedEngine(
            s.eng, max_batch=2, max_wait_ms=20, speculative=2,
            draft_pool=2), serve), (lambda: RefBatched(
                s.ref, max_batch=2, max_wait_ms=20, speculative=2,
                draft_pool=2), ref_serve)):
        batched, port = make(), _free_port()
        httpd = srv(batched, port=port, background=True)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/transcribe?language=en",
                data=audio.tobytes(), method="POST")
            urllib.request.urlopen(req, timeout=300).read()
            stats = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/stats", timeout=30).read())
            out.append(stats["batcher"]["speculative"])
        finally:
            httpd.shutdown()
            batched.close()
    spec, ref_spec = out
    assert spec["recent_batches"] >= 1 and spec["emitted_per_pass"] > 0
    assert spec == ref_spec


def test_cli_transcribe_speculative_matches_plain(setup, tmp_path, capsys):
    """``transcribe --speculative 3 --draft-pool 2`` transcribes a WAV to
    the plain verb's JSON, which is the JAX package's."""
    from nobs_whisper_torch import cli
    from nobs_whisper_torch.audio.io import load_audio, write_wav
    from nobs_whisper_torch.utils.testing import speech_like_audio
    wav = str(tmp_path / "a.wav")
    write_wav(wav, speech_like_audio(1.7, seed=4))
    common = ["transcribe", wav, "--model", setup.target, "--device", "cpu",
              "--dtype", "float32", "--language", "en",
              "--temperature-increment", "0", "--json"]
    outs = []
    for extra in ([], ["--speculative", "3", "--draft-pool", "2"]):
        cli.main(common + extra)
        outs.append(json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1]))
    from nobs_whisper_tpu.decode.rules import DecodeOptions
    want = setup.ref.transcribe(load_audio(wav)[0], language="en",
                                opts=DecodeOptions(temperature_increment=0.0,
                                                   speculative=3,
                                                   draft_pool=2))
    for o in outs:
        assert o["text"] == want.text
        assert [g["tokens"] for g in o["segments"]] == \
            [w.tokens for w in want.segments]


@pytest.mark.parametrize("case", ["draft", "incompatible", "no_speculative",
                                  "beam"])
def test_cli_serve_speculative(setup, tmp_path, monkeypatch, capsys, case):
    """``serve --speculative 3 --draft-pool 2 --draft-model CKPT`` builds a
    speculative ``BatchedEngine`` whose draft is quantized like the target
    (``--quant int8``); a draft of another width, a ``--draft-model``
    without ``--speculative`` and a configured beam strategy each leave
    speculation off, with the reference's message."""
    from nobs_whisper_torch import cli as climod
    from nobs_whisper_torch.ops.quant import is_quantized
    from nobs_whisper_torch.serve.config import ConfigManager
    from nobs_whisper_torch.utils.testing import (tiny_test_config,
                                                  write_tiny_checkpoint)
    monkeypatch.setenv("NOBS_WHISPER_TPU_HOME", str(tmp_path))
    monkeypatch.delenv("NWT_SPECULATIVE", raising=False)
    if case == "beam":
        ConfigManager().update(beam_size=5)
    draft = setup.draft
    if case == "incompatible":
        draft = str(tmp_path / "wide.bin")
        write_tiny_checkpoint(draft, cfg=tiny_test_config(d=128))
    seen = {}
    monkeypatch.setattr("nobs_whisper_torch.serve.server.serve",
                        lambda engine, **kw: seen.update(engine=engine))
    args = argparse.Namespace(
        model=setup.target, host="127.0.0.1", port=0, batch=2, mesh=None,
        dtype="float32", quant="int8", warmup=False,
        speculative=0 if case == "no_speculative" else 3, draft_pool=2,
        draft_model=draft, audio_ctx=0, device="cpu", sample_len=0,
        temperature_increment=None, rss_watermark_mb=0.0)
    climod.cmd_serve(args)
    be, err = seen["engine"], capsys.readouterr().err
    try:
        b = be.batcher
        if case == "draft":
            assert b.speculative == 3 and b.draft_pool == 2
            assert is_quantized(b.draft[0]["decoder"]["blocks"]["fc1_w"])
            assert b.draft[1].n_audio_state == be.cfg.n_audio_state
        else:
            assert b.speculative == 0 and b.draft is None
            assert {"incompatible": "incompatible with target",
                    "no_speculative": "--draft-model needs --speculative",
                    "beam": "applies to greedy batches only"}[case] in err
    finally:
        be.close()
