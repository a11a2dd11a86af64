"""Offline VAD: adaptive-threshold silence detection and chunk splitting.

Behavioral port of the reference's DSP layer (capability contract from
src-tauri/src/audio.rs:331-507): 20 ms RMS windows, a noise floor estimated
as the 10th percentile of the first 25 windows, an adaptive threshold of
max(3x noise floor, 0.5x base), splits at silence centers gated by minimum
silence (700 ms) and minimum chunk (1 s) durations, and 200 ms overlap
carried between chunks. Vectorized NumPy instead of sample loops — this
runs on the ingest host, not the card. (Port of the JAX package's
``audio/vad.py``.)
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.config import SAMPLE_RATE

# constants mirroring src-tauri/src/audio.rs:7-15,338-361
MAX_BUFFER_DURATION_S = 25
CHUNK_OVERLAP_MS = 200
SILENCE_THRESHOLD = 0.01
MIN_SILENCE_DURATION_MS = 700
MIN_CHUNK_DURATION_MS = 1000
NOISE_FLOOR_UPDATE_MAX_FRAMES = 100
ADAPTIVE_THRESHOLD_NOISE_FACTOR = 3.0
MIN_THRESHOLD_FACTOR = 0.5
NOISE_FLOOR_EMA_DECAY = 0.95
NOISE_FLOOR_UPDATE_THRESHOLD_FACTOR = 0.5
NOISE_FLOOR_ESTIMATION_WINDOWS = 25
NOISE_FLOOR_PERCENTILE = 0.1
MIN_NOISE_FLOOR_FACTOR = 0.3


def window_size(sample_rate: int) -> int:
    """20 ms RMS window."""
    return sample_rate // 50


def calculate_rms(samples: np.ndarray) -> float:
    samples = np.asarray(samples, dtype=np.float32)
    if samples.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(samples * samples)))


def windowed_rms(audio: np.ndarray, sample_rate: int) -> np.ndarray:
    """RMS of consecutive non-overlapping 20 ms windows (tail dropped)."""
    w = window_size(sample_rate)
    n = audio.shape[0] // w
    if n == 0:
        return np.zeros(0, np.float32)
    x = np.asarray(audio[: n * w], dtype=np.float32).reshape(n, w)
    return np.sqrt(np.mean(x * x, axis=1))


def estimate_noise_floor(audio: np.ndarray,
                         sample_rate: int = SAMPLE_RATE) -> float:
    """10th percentile of the first 25 x 20 ms window RMS values."""
    w = window_size(sample_rate)
    rms = windowed_rms(audio[: NOISE_FLOOR_ESTIMATION_WINDOWS * w],
                       sample_rate)
    if rms.size == 0:
        return SILENCE_THRESHOLD
    idx = int(rms.size * NOISE_FLOOR_PERCENTILE)
    floor = float(np.sort(rms)[idx])
    return max(floor, SILENCE_THRESHOLD * MIN_NOISE_FLOOR_FACTOR)


def adaptive_threshold(noise_floor: float) -> float:
    return max(noise_floor * ADAPTIVE_THRESHOLD_NOISE_FACTOR,
               SILENCE_THRESHOLD * MIN_THRESHOLD_FACTOR)


def find_silence_boundaries(audio: np.ndarray,
                            sample_rate: int = SAMPLE_RATE) -> List[int]:
    """Sample indices at silence-gap centers, honoring the minimum-silence
    and minimum-chunk gates."""
    audio = np.asarray(audio, dtype=np.float32)
    w = window_size(sample_rate)
    min_silence = sample_rate * MIN_SILENCE_DURATION_MS // 1000
    min_chunk = sample_rate * MIN_CHUNK_DURATION_MS // 1000

    thresh = adaptive_threshold(estimate_noise_floor(audio, sample_rate))
    rms = windowed_rms(audio, sample_rate)
    silent = rms < thresh

    boundaries: List[int] = []
    last_boundary = 0

    def consider(sil_start: int, sil_end: int):
        nonlocal last_boundary
        if sil_end - sil_start >= min_silence:
            split = sil_start + (sil_end - sil_start) // 2
            if split - last_boundary >= min_chunk:
                boundaries.append(split)
                last_boundary = split

    # runs of consecutive silent windows
    run_start = None
    for i, s in enumerate(silent):
        if s and run_start is None:
            run_start = i * w
        elif not s and run_start is not None:
            consider(run_start, i * w)
            run_start = None
    if run_start is not None:
        consider(run_start, audio.shape[0])
    return boundaries


def split_at_silences(audio: np.ndarray, boundaries: List[int],
                      sample_rate: int = SAMPLE_RATE) -> List[np.ndarray]:
    """Split at boundary indices, prepending 200 ms overlap to each chunk
    after the first. No boundaries -> one chunk."""
    audio = np.asarray(audio, dtype=np.float32)
    if not boundaries:
        return [audio.copy()]
    overlap = sample_rate * CHUNK_OVERLAP_MS // 1000
    chunks: List[np.ndarray] = []
    start = 0
    for b in boundaries:
        if start < b < audio.shape[0]:
            chunks.append(audio[max(start - overlap, 0): b].copy())
            start = b
    if start < audio.shape[0]:
        chunks.append(audio[max(start - overlap, 0):].copy())
    return chunks
