"""Sample-rate conversion to Whisper's 16 kHz.

Replaces the reference's rubato FFT resampler (src-tauri/src/audio.rs:509-
563). Host path: polyphase scipy (exact rational ratios, e.g. 48k->16k).
The JAX package's device-side twin (``resample_jax``, an experiment off
the serving path) is not ported yet (ROADMAP.md queue 1, item 10).
"""

from __future__ import annotations

import fractions

import numpy as np

from ..core.config import SAMPLE_RATE


def resample(audio: np.ndarray, in_rate: int,
             out_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Polyphase resample (host). Identity when rates match."""
    audio = np.asarray(audio, dtype=np.float32)
    if in_rate == out_rate:
        return audio
    from scipy.signal import resample_poly
    frac = fractions.Fraction(out_rate, in_rate)
    out = resample_poly(audio.astype(np.float64), frac.numerator,
                        frac.denominator)
    expected = int(round(len(audio) * out_rate / in_rate))
    if len(out) > expected:
        out = out[:expected]
    elif len(out) < expected:
        out = np.pad(out, (0, expected - len(out)))
    return out.astype(np.float32)
