"""Streaming audio buffer with real-time adaptive VAD chunking.

Behavioral port of the reference's ``AudioBuffer`` (capability contract
from src-tauri/src/audio.rs:30-241): push PCM, track the last speech
position against an adaptive EMA noise floor, emit a chunk when >=700 ms of
silence follows >=0.5 s of speech (split mid-silence), or force a split at
the quietest 20 ms window of the last 5 s once the buffer exceeds 25 s.
200 ms of overlap is carried into each next chunk to avoid word cuts.

On a serving host there is no microphone; this buffer is fed by the ingestion
layer (WAV/PCM readers, sockets) instead of a CoreAudio callback. (Port
of the JAX package's ``audio/buffer.py``.)
"""

from __future__ import annotations

import threading
from typing import List, Optional

import numpy as np

from .vad import (ADAPTIVE_THRESHOLD_NOISE_FACTOR, CHUNK_OVERLAP_MS,
                  MAX_BUFFER_DURATION_S, MIN_SILENCE_DURATION_MS,
                  MIN_THRESHOLD_FACTOR, NOISE_FLOOR_EMA_DECAY,
                  NOISE_FLOOR_UPDATE_MAX_FRAMES,
                  NOISE_FLOOR_UPDATE_THRESHOLD_FACTOR, SILENCE_THRESHOLD,
                  window_size, windowed_rms)


class AudioBuffer:
    """Single-producer streaming buffer. Thread-safe via an internal lock
    (the reference wraps it in Arc<Mutex<_>>, audio.rs:244)."""

    def __init__(self, sample_rate: int = 48_000):
        self.sample_rate = sample_rate
        self._lock = threading.Lock()
        self._chunks: List[np.ndarray] = []   # appended segments
        self._n = 0                           # total samples buffered
        self.last_speech_pos = 0
        self.noise_floor = SILENCE_THRESHOLD
        self._noise_frames = 0
        self._overlap = np.zeros(0, np.float32)

    # ------------------------------------------------------------------
    def adaptive_threshold(self) -> float:
        return max(self.noise_floor * ADAPTIVE_THRESHOLD_NOISE_FACTOR,
                   SILENCE_THRESHOLD * MIN_THRESHOLD_FACTOR)

    def push_samples(self, samples: np.ndarray) -> None:
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        with self._lock:
            start_pos = self._n
            self._chunks.append(samples)
            self._n += samples.size

            # Rust's samples.chunks(window_size) INCLUDES the final
            # partial chunk (audio.rs:66) — so must we, or callers that
            # push sub-window packets (e.g. 10 ms callbacks against a
            # 20 ms window) would never have ANY window analyzed: no
            # speech detection, no noise-floor adaptation, and
            # silence-boundary chunking permanently dead.
            w = window_size(self.sample_rate)
            rms = list(windowed_rms(samples, self.sample_rate))
            ends = [(i + 1) * w for i in range(len(rms))]
            tail = samples[len(rms) * w:]
            if tail.size:
                rms.append(float(np.sqrt(np.mean(tail * tail))))
                ends.append(samples.size)
            for r, end in zip(rms, ends):
                if (r < self.noise_floor * NOISE_FLOOR_UPDATE_THRESHOLD_FACTOR
                        and self._noise_frames < NOISE_FLOOR_UPDATE_MAX_FRAMES):
                    self.noise_floor = (self.noise_floor *
                                        NOISE_FLOOR_EMA_DECAY +
                                        float(r) * (1 - NOISE_FLOOR_EMA_DECAY))
                    self._noise_frames += 1
                if r >= self.adaptive_threshold():
                    self.last_speech_pos = start_pos + end

    # ------------------------------------------------------------------
    def _samples(self) -> np.ndarray:
        if len(self._chunks) > 1:
            self._chunks = [np.concatenate(self._chunks)]
        return self._chunks[0] if self._chunks else np.zeros(0, np.float32)

    def __len__(self) -> int:
        return self._n

    def take(self) -> np.ndarray:
        """Drain everything (stop-recording path).

        NB the pending 200 ms overlap is deliberately DISCARDED, not
        prepended: the reference's drain does exactly this
        (AudioBuffer::take clears overlap_buffer, audio.rs:89-93) — the
        overlap's samples were already transcribed at the tail of the
        previous chunk, and the reference accepts the mid-word cut on
        the residue after a forced split. Intentional behavioral
        parity, not an oversight."""
        with self._lock:
            out = self._samples()
            self._chunks = []
            self._n = 0
            self.last_speech_pos = 0
            self._overlap = np.zeros(0, np.float32)
            return out

    def has_silence_boundary(self) -> bool:
        with self._lock:
            return self._has_silence_boundary()

    def _has_silence_boundary(self) -> bool:
        if self._n == 0 or self.last_speech_pos == 0:
            return False
        silence = max(self._n - self.last_speech_pos, 0)
        return silence >= self.sample_rate * MIN_SILENCE_DURATION_MS // 1000

    def _extract(self, split_point: int) -> np.ndarray:
        """Cut [0, split_point) with the previous overlap prepended, retain
        the tail overlap, drop consumed samples."""
        data = self._samples()
        overlap_n = self.sample_rate * CHUNK_OVERLAP_MS // 1000
        chunk = np.concatenate([self._overlap, data[:split_point]])
        self._overlap = data[max(split_point - overlap_n, 0):
                             split_point].copy()
        rest = data[split_point:]
        self._chunks = [rest] if rest.size else []
        self._n = rest.size
        return chunk

    def take_chunk_at_silence(self) -> Optional[np.ndarray]:
        """Emit the speech portion once a silence boundary exists; split at
        the middle of the silence run. Requires >=0.5 s of speech."""
        with self._lock:
            if not self._has_silence_boundary():
                return None
            if self.last_speech_pos < self.sample_rate // 2:
                return None
            silence_start = self.last_speech_pos
            split_point = silence_start + (self._n - silence_start) // 2
            chunk = self._extract(split_point)
            self.last_speech_pos = 0
            return chunk

    def take_forced_chunk(self) -> Optional[np.ndarray]:
        """Once the buffer exceeds 25 s: split at the center of the quietest
        20 ms window within the last 5 s."""
        with self._lock:
            if self._n <= self.sample_rate * MAX_BUFFER_DURATION_S:
                return None
            data = self._samples()
            w = window_size(self.sample_rate)
            search_start = max(self._n - 5 * self.sample_rate, 0)
            rms = windowed_rms(data[search_start:], self.sample_rate)
            if rms.size == 0:
                return None
            quietest = search_start + int(np.argmin(rms)) * w
            split_point = min(quietest + w // 2, self._n)
            if split_point < self.sample_rate // 2:
                return None
            chunk = self._extract(split_point)
            self.last_speech_pos = max(self.last_speech_pos - split_point, 0)
            return chunk

    def poll_chunk(self) -> Optional[np.ndarray]:
        """Streaming helper: silence-boundary chunk, else forced split."""
        chunk = self.take_chunk_at_silence()
        if chunk is not None:
            return chunk
        return self.take_forced_chunk()
