"""Streaming transcription session: the push-to-talk state machine (port
of the JAX package's ``pipeline/session.py``, on the port's engines).

Behavioral port of the reference's recording orchestration
(src-tauri/src/state.rs): idempotent start/stop/toggle/cancel
(state.rs:479,655,857,874), a chunk-consuming transcription worker that
overlaps decode of chunk N with capture of chunk N+1 (state.rs:114-168,549),
inline VAD chunk dispatch on the audio push path (state.rs:585-607), a
recording duration hard-cap (600 s, state.rs:361,565), drain + >30 s
silence-split finalization (state.rs:732-778), rolling text context between
chunks (state.rs:147,766), and per-chunk error isolation (state.rs:157-159).

OS hotkeys/indicator are replaced by verbs + an event callback stream
(recording/processing/done/cancelled) for the serving layer.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..audio.buffer import AudioBuffer
from ..audio.resample import resample
from ..audio.vad import find_silence_boundaries, split_at_silences
from ..native import make_audio_buffer
from ..core.config import SAMPLE_RATE

log = logging.getLogger(__name__)

# reference: default 60 s, 0 = unlimited capped at 600 s
# (config.rs:36-38, state.rs:361,565)
MAX_RECORDING_HARD_CAP_S = 600
# reference: minimum transcribable audio 0.1 s (state.rs:265,749)
MIN_TRANSCRIBABLE_S = 0.1
# reference: >30 s final residue is silence-split (state.rs:757-778)
FINAL_SPLIT_THRESHOLD_S = 30


class SessionState(enum.Enum):
    IDLE = "idle"
    RECORDING = "recording"
    PROCESSING = "processing"


@dataclasses.dataclass
class SessionEvent:
    state: str     # recording | processing | partial | done | cancelled
    transcript: Optional[str] = None
    is_final: bool = False


@dataclasses.dataclass
class SessionConfig:
    language: Optional[str] = None       # None/auto -> detect
    vocabulary: Optional[str] = None     # custom-vocab prompt biasing
    sample_rate: int = 48_000            # ingest rate
    max_duration_s: int = 60             # 0 = unlimited (capped at 600)
    # decode strategy (reference analog: strategy selection at
    # whisper.rs:88; defaults = greedy parity). beam_size > 1 runs beam
    # search at temperature 0; best_of > 1 samples candidates on the
    # fallback rungs; temperature sets the ladder's first rung. Every
    # field is tri-state: None = inherit the engine's configured
    # strategy; an EXPLICIT value — including beam_size=1 / best_of=1 /
    # temperature=0 — forces DecodeOptions, so a session can opt OUT of
    # a beam/temperature-configured engine back to greedy.
    beam_size: Optional[int] = None
    best_of: Optional[int] = None
    temperature: Optional[float] = None
    # transcribe | translate | None — the engine's task capability
    # (whisper.cpp's translate flag; the reference leaves it off at
    # whisper.rs:116 but the config surface is where engine capability
    # is selected, so the session exposes it like beam_size above).
    # None = inherit the engine's configured default; an EXPLICIT
    # "transcribe" forces DecodeOptions so it overrides a
    # translate-configured BatchedEngine instead of inheriting it.
    task: Optional[str] = None

    @property
    def effective_max_s(self) -> int:
        if self.max_duration_s <= 0:
            return MAX_RECORDING_HARD_CAP_S
        return min(self.max_duration_s, MAX_RECORDING_HARD_CAP_S)

    def decode_opts(self):
        """DecodeOptions for this session, or None for engine defaults
        (the greedy fast path).

        Inheritance is all-or-nothing: once ANY strategy field is set,
        the remaining unset fields resolve to greedy defaults, not to
        the engine's configured strategy (the engine's defaults are not
        visible here). The serving layer avoids the gap by resolving
        AppConfig values into the session fields at creation
        (serve/server.py::_create_session); direct library users who
        mix a partially-set SessionConfig with a non-default engine
        strategy should set every field they care about."""
        if (self.beam_size is None and self.best_of is None
                and self.temperature is None and self.task is None):
            return None
        from ..decode.rules import DecodeOptions
        beam = self.beam_size or 1
        return DecodeOptions(
            beam_size=beam if beam > 1 else None,
            best_of=max(self.best_of or 1, 1),
            temperature=float(self.temperature or 0.0),
            task=self.task or "transcribe")


class StreamingSession:
    """One push-to-talk session. Thread-safe verbs; a dedicated worker
    transcribes chunks while audio keeps streaming in."""

    def __init__(self, engine, config: Optional[SessionConfig] = None,
                 on_event: Optional[Callable[[SessionEvent], None]] = None):
        self.engine = engine
        self.config = config or SessionConfig()
        self.on_event = on_event or (lambda e: None)
        self._lock = threading.Lock()
        self.state = SessionState.IDLE
        self._buffer: Optional[AudioBuffer] = None
        self._chunk_q: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._results: List[str] = []
        self._results_lock = threading.Lock()
        self._started_at = 0.0
        self._cancelled = False
        # recording generation: incremented by every start(). Detached
        # workers/finalizers capture their generation and refuse to
        # touch state, emit events, or write results once a NEWER
        # recording exists — without this, a stale finalize from a
        # cancelled session could force the new session back to IDLE
        # and overwrite its transcript.
        self._gen = 0
        self._finalize_thread: Optional[threading.Thread] = None
        self.last_transcript: Optional[str] = None

    # ------------------------------------------------------------------
    def _emit(self, state: str, transcript: Optional[str] = None,
              final: bool = False):
        try:
            self.on_event(SessionEvent(state=state, transcript=transcript,
                                       is_final=final))
        except Exception:
            log.exception("event callback failed")

    def _worker_loop(self, q: queue.Queue, results: List[str], gen: int):
        """Chunk consumer: resample -> transcribe with rolling context ->
        ordered results. A failed chunk is logged and skipped.

        ``results`` is THIS generation's list (never self._results — a
        later start() swaps that attribute and a stale worker would
        append to the new session). Each finished chunk is emitted live
        as a ``partial`` event — the streaming analog of the reference
        accumulating results while recording continues
        (state.rs:147-155) — and the first one records the session's
        first-partial latency in /stats."""
        rolling: Optional[str] = None
        while True:
            item = q.get()
            if item is None:
                return
            try:
                audio16k = resample(item, self.config.sample_rate,
                                    SAMPLE_RATE)
                r = self.engine.transcribe(
                    audio16k, language=self.config.language,
                    vocabulary=self.config.vocabulary, context=rolling,
                    opts=self.config.decode_opts())
                if r.text:
                    with self._results_lock:
                        first = not results
                        results.append(r.text)
                    rolling = r.text
                    if first:
                        from ..utils.profiling import GLOBAL_PROFILER
                        GLOBAL_PROFILER.record(
                            "first_partial",
                            time.monotonic() - self._started_at)
                    if not self._cancelled and gen == self._gen:
                        self._emit("partial", transcript=r.text)
            except Exception:
                log.exception("streaming chunk failed; skipping")

    # ------------------------------------------------------------------
    # verbs (idempotent, like state.rs:487,662,881)
    # ------------------------------------------------------------------
    def start(self) -> bool:
        with self._lock:
            if self.state != SessionState.IDLE:
                return False  # already recording/processing: no-op
            # native C++ engine when built (bit-parity twin of the
            # Python AudioBuffer, test_native.py pins it), NumPy
            # fallback otherwise — the serving hot path runs the native
            # VAD/chunking off the Python heap
            self._buffer = make_audio_buffer(self.config.sample_rate)
            self._chunk_q = queue.Queue()
            self._results = []
            self._cancelled = False
            self._gen += 1
            self._started_at = time.monotonic()
            self._worker = threading.Thread(
                target=self._worker_loop,
                args=(self._chunk_q, self._results, self._gen),
                daemon=True)
            self._worker.start()
            self.state = SessionState.RECORDING
        self._emit("recording")
        return True

    def push_audio(self, frames: np.ndarray) -> None:
        """Ingest path = the reference's cpal callback: buffer the frames,
        then dispatch any VAD-ready chunk to the worker.

        Runs entirely under the session lock: a push racing stop() could
        otherwise write samples into the already-drained buffer (audio
        silently lost) or enqueue a chunk behind the worker's shutdown
        sentinel. The buffer push is a memcpy + windowed RMS and the
        queue is unbounded, so holding the lock is cheap."""
        with self._lock:
            if self.state != SessionState.RECORDING:
                return
            buf, q = self._buffer, self._chunk_q
            buf.push_samples(frames)
            chunk = buf.poll_chunk()
            if chunk is not None and q is not None:
                q.put(chunk)

    def elapsed_s(self) -> float:
        return (time.monotonic() - self._started_at
                if self.state == SessionState.RECORDING else 0.0)

    def over_duration_cap(self) -> bool:
        return self.elapsed_s() >= self.config.effective_max_s

    def stop(self, wait: bool = True) -> Optional[str]:
        """Finalize: drain worker, transcribe the residue (silence-split if
        >30 s), join results. Returns the final transcript (when wait)."""
        started = False
        fin = None
        with self._lock:
            if self.state == SessionState.RECORDING:
                started = True
                self.state = SessionState.PROCESSING
                buf, q, worker = self._buffer, self._chunk_q, self._worker
                self._buffer = None
                self._chunk_q = None
                self._worker = None
                gen = self._gen
                results = self._results
            elif self.state == SessionState.PROCESSING:
                # a detached finalize is still computing THIS recording's
                # transcript — join it before answering, or the caller
                # would get the PREVIOUS recording's text
                fin = self._finalize_thread
        if not started:
            if wait and fin is not None:
                fin.join(timeout=900)
            return self.last_transcript if wait else None
        self._emit("processing")

        def finalize() -> str:
            q.put(None)            # close the queue -> worker drains & exits
            worker.join(timeout=120)
            if worker.is_alive():
                # a chunk transcribe is still grinding (a long queue of
                # chunks, each a full window decode) — proceeding would
                # snapshot a truncated result set; say so instead of
                # staying silent
                log.warning("session worker still busy after 120 s; the "
                            "final transcript may miss in-flight chunks")

            def stale() -> bool:
                # a cancel() or a NEWER recording owns the session now;
                # this finalize must not touch state or emit anything
                return self._cancelled or self._gen != gen

            if stale():
                return ""
            remaining = buf.take()
            texts: List[str]
            with self._results_lock:
                texts = list(results)
            rolling = texts[-1] if texts else None
            audio16k = resample(remaining, self.config.sample_rate,
                                SAMPLE_RATE)
            if audio16k.size >= int(MIN_TRANSCRIBABLE_S * SAMPLE_RATE):
                pieces = [audio16k]
                if audio16k.size > FINAL_SPLIT_THRESHOLD_S * SAMPLE_RATE:
                    bounds = find_silence_boundaries(audio16k, SAMPLE_RATE)
                    pieces = split_at_silences(audio16k, bounds, SAMPLE_RATE)
                for piece in pieces:
                    try:
                        r = self.engine.transcribe(
                            piece, language=self.config.language,
                            vocabulary=self.config.vocabulary,
                            context=rolling,
                            opts=self.config.decode_opts())
                    except Exception:
                        log.exception("final chunk failed; skipping")
                        continue
                    if r.text:
                        texts.append(r.text)
                        rolling = r.text
                        if not stale():
                            self._emit("partial", transcript=r.text)
            final_text = " ".join(texts)
            with self._lock:
                if stale():       # cancelled / superseded mid-transcription
                    return ""
                self.state = SessionState.IDLE
                self.last_transcript = final_text
            self._emit("done", transcript=final_text, final=True)
            return final_text

        if wait:
            return finalize()
        t = threading.Thread(target=finalize, daemon=True)
        self._finalize_thread = t
        t.start()
        return None

    def toggle(self) -> bool:
        """Returns True if now recording (state.rs:857-871)."""
        if self.state == SessionState.RECORDING:
            self.stop(wait=False)
            return False
        return self.start()

    def cancel(self) -> None:
        """ESC semantics: discard audio, results, and worker output
        (state.rs:874-914)."""
        with self._lock:
            if self.state == SessionState.IDLE:
                return
            self._cancelled = True
            q, worker = self._chunk_q, self._worker
            self._buffer = None
            self._chunk_q = None
            self._worker = None
            self._results = []
            self.state = SessionState.IDLE
        if q is not None:
            q.put(None)
        self._emit("cancelled")
