"""Speech-like audio for the benchmark's requests.

``speech_like_audio`` is a frozen copy of
``nobs_whisper_torch/utils/testing.py::speech_like_audio`` as of the
port's twenty-first slice: band-limited noise bursts of 0.3-1.5 s with
pauses of 0.2-1.0 s, the shape a VAD cuts into chunks. A request's audio
is a slice of one such tape made from the run's seed, so the tape is made
once a run and every request still hears different audio.
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16000


def speech_like_audio(duration_s: float, seed: int = 0,
                      sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Band-limited noise bursts with pauses."""
    rng = np.random.RandomState(seed)
    n = int(duration_s * sample_rate)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        burst = int(rng.uniform(0.3, 1.5) * sample_rate)
        gap = int(rng.uniform(0.2, 1.0) * sample_rate)
        seg = rng.randn(min(burst, n - pos)).astype(np.float32) * 0.2
        out[pos:pos + seg.size] = seg
        pos += burst + gap
    return out


def tape(seconds: float, seed: int) -> np.ndarray:
    """The run's tape: ``speech_like_audio`` seeded from the low 31 bits
    of ``seed`` mixed with its high bits (RandomState takes 32 bits)."""
    return speech_like_audio(seconds, seed=int((seed ^ (seed >> 31))
                                               % (2 ** 31 - 1)))
