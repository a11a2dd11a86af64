"""Streaming session state machine: idempotency, VAD dispatch, finalize,
cancel-discard, duration cap. Uses a fake engine — the machine logic is
engine-independent (mirroring how the reference unit-tests around the FFI)."""

import threading
import time

import numpy as np
import pytest
import torch

from nobs_whisper_torch.pipeline.session import (
    MAX_RECORDING_HARD_CAP_S, SessionConfig, SessionState, StreamingSession)

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

SR = 16000


class FakeEngine:
    """Echoes chunk durations; records contexts passed in."""

    def __init__(self, fail_on=None):
        self.calls = []
        self.fail_on = fail_on or set()
        self.lock = threading.Lock()

    def transcribe(self, audio, language=None, vocabulary=None,
                   context=None, opts=None):
        with self.lock:
            idx = len(self.calls)
            self.calls.append(dict(n=len(audio), context=context,
                                   vocabulary=vocabulary))
        if idx in self.fail_on:
            raise RuntimeError("boom")

        class R:
            pass

        r = R()
        r.text = f"chunk{idx}"
        r.segments = []
        r.language = language or "en"
        return r


def _speech(duration_s, sr=SR):
    t = np.arange(int(duration_s * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)


def _silence(duration_s, sr=SR):
    return np.zeros(int(duration_s * sr), np.float32)


def make_session(engine=None, **kw):
    events = []
    cfg = SessionConfig(sample_rate=SR, **kw)
    s = StreamingSession(engine or FakeEngine(), cfg,
                         on_event=events.append)
    return s, events


def test_start_stop_idempotent():
    s, events = make_session()
    assert s.start() is True
    assert s.start() is False          # second start: no-op
    assert s.state == SessionState.RECORDING
    out = s.stop()
    assert s.state == SessionState.IDLE
    assert s.stop() == out             # stop when idle returns last


def test_streaming_chunks_and_finalize():
    eng = FakeEngine()
    s, events = make_session(eng)
    s.start()
    # speech then >700ms silence triggers a streaming chunk
    s.push_audio(_speech(2.0))
    s.push_audio(_silence(1.0))
    deadline = time.time() + 5
    while not eng.calls and time.time() < deadline:
        time.sleep(0.01)
    assert len(eng.calls) >= 1         # worker got the VAD chunk
    s.push_audio(_speech(1.0))         # residue finalized on stop
    out = s.stop()
    assert out.startswith("chunk")
    assert "chunk" in out
    # rolling context: second call received first chunk's text
    if len(eng.calls) >= 2:
        assert eng.calls[1]["context"] == "chunk0"
    states = [e.state for e in events]
    assert states[0] == "recording"
    assert "processing" in states
    assert states[-1] == "done"
    assert events[-1].is_final
    # live streaming: every finished chunk was emitted as a partial
    # BEFORE done (reference accumulates results live, state.rs:147-155)
    partials = [e for e in events if e.state == "partial"]
    assert partials, "no partial events emitted"
    assert all(p.transcript.startswith("chunk") for p in partials)
    assert states.index("partial") < states.index("done")
    # first-partial latency recorded for /stats
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    snap = GLOBAL_PROFILER.snapshot()
    assert snap.get("first_partial", {}).get("count", 0) >= 1


def test_cancel_discards_everything():
    eng = FakeEngine()
    s, events = make_session(eng)
    s.start()
    s.push_audio(_speech(2.0))
    s.cancel()
    assert s.state == SessionState.IDLE
    assert events[-1].state == "cancelled"
    assert s.last_transcript is None
    s.cancel()                          # idempotent
    assert events[-1].state == "cancelled"


def test_cancel_during_processing_discards():
    """cancel() racing a detached finalize must win: no 'done' event, no
    stored transcript (reference discard-everything cancel,
    state.rs:874-914)."""
    class SlowEngine(FakeEngine):
        def transcribe(self, *a, **kw):
            time.sleep(0.3)
            return super().transcribe(*a, **kw)

    eng = SlowEngine()
    s, events = make_session(eng)
    s.start()
    s.push_audio(_speech(2.0))          # residue -> finalize transcribes
    s.stop(wait=False)                  # detached finalize starts
    time.sleep(0.05)
    s.cancel()                          # while PROCESSING
    time.sleep(0.6)                     # let the finalize thread finish
    assert s.state == SessionState.IDLE
    assert s.last_transcript is None
    assert events[-1].state == "cancelled"
    assert all(e.state != "done" for e in events)


def test_toggle():
    s, _ = make_session()
    assert s.toggle() is True
    assert s.state == SessionState.RECORDING
    assert s.toggle() is False
    deadline = time.time() + 5
    while s.state != SessionState.IDLE and time.time() < deadline:
        time.sleep(0.01)
    assert s.state == SessionState.IDLE


def test_chunk_error_isolation():
    """A failing chunk is skipped; later chunks still transcribe
    (state.rs:157-159 semantics)."""
    eng = FakeEngine(fail_on={0})
    s, _ = make_session(eng)
    s.start()
    s.push_audio(_speech(2.0))
    s.push_audio(_silence(1.0))        # -> chunk0 (fails)
    deadline = time.time() + 5
    while len(eng.calls) < 1 and time.time() < deadline:
        time.sleep(0.01)
    s.push_audio(_speech(1.0))
    out = s.stop()
    assert "chunk" in out              # finalize chunk still present
    assert "chunk0" not in out


def test_tiny_residue_not_transcribed():
    eng = FakeEngine()
    s, _ = make_session(eng)
    s.start()
    s.push_audio(_speech(0.05))        # < 0.1 s minimum
    out = s.stop()
    assert out == ""
    assert eng.calls == []


def test_duration_cap():
    s, _ = make_session(max_duration_s=0)
    assert s.config.effective_max_s == MAX_RECORDING_HARD_CAP_S
    s2, _ = make_session(max_duration_s=30)
    assert s2.config.effective_max_s == 30
    s3, _ = make_session(max_duration_s=100000)
    assert s3.config.effective_max_s == MAX_RECORDING_HARD_CAP_S


def test_push_when_idle_is_noop():
    eng = FakeEngine()
    s, _ = make_session(eng)
    s.push_audio(_speech(1.0))         # not recording: dropped
    assert s.state == SessionState.IDLE
    assert eng.calls == []
