"""Sample-rate conversion to Whisper's 16 kHz.

Replaces the reference's rubato FFT resampler (src-tauri/src/audio.rs:509-
563). Host path: polyphase scipy (exact rational ratios, e.g. 48k->16k);
device path: :func:`resample_torch`, a polyphase gather on the input
tensor's device, which the serving path does not use.
"""

from __future__ import annotations

import fractions
import functools

import numpy as np
import torch

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


@functools.lru_cache(maxsize=8)
def _polyphase_filter_np(up: int, down: int, taps_per_phase: int = 24):
    """Windowed-sinc anti-aliasing filter split into ``up`` phases."""
    n_taps = taps_per_phase * up
    cutoff = 1.0 / max(up, down)
    t = np.arange(n_taps) - (n_taps - 1) / 2
    h = np.sinc(t * cutoff) * cutoff * up
    h *= np.hamming(n_taps)
    # phase p uses taps h[p::up]
    return h.astype(np.float32)


def resample_torch(audio, in_rate: int, out_rate: int = SAMPLE_RATE
                   ) -> torch.Tensor:
    """Polyphase resample on the input tensor's device: a strided gather of
    input windows times a per-phase filter bank, summed over the taps. The
    twin of the JAX package's ``audio/resample.py::resample_jax``, with its
    length and group delay.

    Not interchangeable with the host :func:`resample`: this returns
    floor(n*up/down) samples (the host pads or trims to round(n*out/in)),
    and its group-delay compensation differs by ~0.5 input sample for
    integer downsampling ratios. The serving path uses the host and native
    resamplers only."""
    x = torch.as_tensor(audio).to(torch.float32)
    if in_rate == out_rate:
        return x
    frac = fractions.Fraction(out_rate, in_rate)
    up, down = frac.numerator, frac.denominator
    h = _polyphase_filter_np(up, down)
    taps_pp = h.shape[0] // up
    n_out = (x.shape[0] * up) // down
    # output sample j reads upsampled index j*down: phase (j*down) % up, its
    # window centred (half the per-phase taps: the group delay) on the
    # input sample (j*down)//up
    j = np.arange(n_out)
    phase = (j * down) % up
    start = (j * down) // up + taps_pp // 2
    idx = start[:, None] - np.arange(taps_pp)[None, :] + taps_pp
    xp = torch.nn.functional.pad(x, (taps_pp, taps_pp))
    windows = xp[torch.as_tensor(idx, device=x.device)]
    bank = np.stack([h[p::up] for p in range(up)])
    coeffs = torch.as_tensor(bank[phase], device=x.device)
    return torch.sum(windows * coeffs, dim=1)
