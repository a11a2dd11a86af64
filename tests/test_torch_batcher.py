"""The port's ``WindowBatcher`` watchdog on the CPU, a twin of
``tests/test_batcher.py::test_watchdog_fails_wedged_batch``: a batch that
never returns fails its futures with ``TimeoutError`` at the deadline, the
batcher counts the trip and goes on serving; the next request's tokens
equal the reference's decode of the same window.
"""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    return (JaxEngine.from_ggml(path, dtype=jnp.float32),
            WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu"))


def _batcher(eng, **kw):
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batcher import WindowBatcher
    return WindowBatcher(eng.params, eng.cfg, eng.tokenizer, DecodeOptions(),
                         max_batch=2, max_wait_ms=5, device="cpu", **kw)


def _window(cfg):
    rng = np.random.RandomState(4)
    return rng.randn(cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)


def test_watchdog_fails_wedged_batch(engines, monkeypatch):
    """A batch stuck in its decode fails at the 1.5 s deadline with
    ``TimeoutError``; ``watchdog_trips`` is 1; once the stub is released
    the next request is served, with the reference's tokens."""
    import nobs_whisper_torch.decode.greedy as greedy_mod
    from nobs_whisper_tpu.decode.greedy import decode_window
    from nobs_whisper_tpu.decode.rules import DecodeOptions as JaxOptions
    from nobs_whisper_tpu.decode.rules import build_rule_tables
    from nobs_whisper_tpu.models.whisper import encode
    ref, eng = engines
    cfg = eng.cfg
    wedge = {"on": True}
    release = threading.Event()
    real_finalize = greedy_mod.decode_window_finalize

    def wedged_finalize(handle):
        if wedge["on"]:
            wedge["on"] = False
            release.wait(30)       # the indefinite hang, bounded
        return real_finalize(handle)

    mel = _window(cfg)
    prompt = eng.tokenizer.sot_sequence(language="en")
    batcher = _batcher(eng, batch_deadline_s=1.5)
    try:
        assert batcher.submit(mel, prompt).result(timeout=120).tokens
        monkeypatch.setattr(greedy_mod, "decode_window_finalize",
                            wedged_finalize)
        f1 = batcher.submit(mel, prompt)
        with pytest.raises(TimeoutError, match="wedged"):
            f1.result(timeout=30)
        assert batcher.watchdog_trips == 1
        release.set()              # un-wedge the abandoned thread
        got = batcher.submit(mel, prompt).result(timeout=120)
        assert batcher.watchdog_trips == 1
    finally:
        release.set()
        batcher.close()
    opts = JaxOptions()
    xa = encode(ref.params, jnp.asarray(mel[None]), ref.cfg)
    want = decode_window(ref.params, xa, [prompt], ref.cfg,
                         build_rule_tables(ref.cfg, opts, ref.tokenizer),
                         opts)[0]
    assert got.tokens == want.tokens


def test_failed_batch_fails_its_futures(engines, monkeypatch):
    """An exception in the batch fails that batch's futures with itself
    (no watchdog trip), and the batcher serves the next request."""
    import nobs_whisper_torch.decode.greedy as greedy_mod
    _, eng = engines
    real_finalize = greedy_mod.decode_window_finalize
    calls = {"n": 0}

    def failing_finalize(handle):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("decode broke")
        return real_finalize(handle)

    monkeypatch.setattr(greedy_mod, "decode_window_finalize",
                        failing_finalize)
    mel = _window(eng.cfg)
    prompt = eng.tokenizer.sot_sequence(language="en")
    batcher = _batcher(eng, batch_deadline_s=60.0)
    try:
        with pytest.raises(RuntimeError, match="decode broke"):
            batcher.submit(mel, prompt).result(timeout=60)
        assert batcher.submit(mel, prompt).result(timeout=120).tokens
        assert batcher.watchdog_trips == 0
    finally:
        batcher.close()


@pytest.mark.parametrize("arg,env,want", [
    (2.5, "7", 2.5), (None, "7", 7.0), (None, None, 900.0)],
    ids=["constructor", "env", "default"])
def test_batch_deadline_resolution(engines, monkeypatch, arg, env, want):
    """The deadline comes from the constructor, else
    ``NWT_BATCH_DEADLINE_S``, else 900 s, as in the reference."""
    _, eng = engines
    if env is None:
        monkeypatch.delenv("NWT_BATCH_DEADLINE_S", raising=False)
    else:
        monkeypatch.setenv("NWT_BATCH_DEADLINE_S", env)
    batcher = _batcher(eng, batch_deadline_s=arg)
    try:
        assert batcher.batch_deadline_s == want
        assert batcher.watchdog_trips == 0
    finally:
        batcher.close()
