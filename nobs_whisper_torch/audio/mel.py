"""Log-mel spectrogram front-end (PyTorch port of ``audio/mel.py``).

16 kHz PCM -> STFT (400-pt hann, hop 160) -> 80/128-bin slaney mel ->
log10 -> dynamic-range clamp -> (x+4)/4, whisper semantics:
:func:`log_mel_spectrogram` on raw PCM, :func:`log_mel_longform` on long
audio, and the framed serving path (:func:`frame_window_np` +
:func:`log_mel_from_frames`). The DFT is two float32 matmuls against
window-folded cos/sin bases, as in the reference (where XLA runs them at
``HIGHEST`` precision): TF32 must be off, which
``core/device.py::disable_tf32`` sets. :func:`log_mel_numpy_f64` is the
float64 oracle. K14, the hand-written CUDA variant of the raw-PCM path on
30 s windows, lives in ``ops/mel_pallas.py`` and must match this to float
tolerance.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..core.config import HOP_LENGTH, N_FFT, N_FRAMES, N_SAMPLES
from ..core.device import disable_tf32


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale hz->mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = 3.0 * freq / 200.0
    min_log_hz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) /
                                         min_log_hz) * logstep,
                    mels)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = 200.0 * mels / 3.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    freq)


@functools.lru_cache(maxsize=4)
def mel_filter_bank(n_mels: int, sample_rate: int = 16_000,
                    n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, n_fft//2+1)
    (librosa.filters.mel defaults, as shipped in whisper checkpoints)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_min = hz_to_mel_slaney(np.array(0.0))
    mel_max = hz_to_mel_slaney(np.array(sample_rate / 2))
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _dft_bases_np(n_fft: int = N_FFT):
    """Real-DFT as matmul: periodic-hann-folded cos/sin bases,
    (n_fft, n_freqs) each."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


def _bases_and_bank(n_mels: int):
    """The cos/sin bases (n_fft, n_freqs) and the (n_mels, n_freqs)
    filterbank, numpy f32."""
    return (*_dft_bases_np(), mel_filter_bank(n_mels))


@functools.lru_cache(maxsize=16)
def device_tables(make, n_mels: int, device: torch.device):
    """The numpy arrays ``make(n_mels)`` returns, as tensors on ``device``,
    copied there once (the front end's one cache of device tables)."""
    return tuple(torch.from_numpy(t).to(device) for t in make(n_mels))


def frame_signal(audio: torch.Tensor) -> torch.Tensor:
    """Center-padded (reflect) strided framing: (..., T) -> (..., n_frames,
    n_fft), n_frames = T // hop (the trailing STFT frame is dropped).
    Frame i is rows i, i+1 and the first half of row i+2 of the (n+2, 160)
    reshape. T must exceed the 200-sample reflect pad."""
    pad = N_FFT // 2
    lead, t = audio.shape[:-1], audio.shape[-1]
    padded = torch.nn.functional.pad(audio.reshape(-1, 1, t), (pad, pad),
                                     mode="reflect").reshape(*lead, -1)
    n_frames = t // HOP_LENGTH
    need = (n_frames + 2) * HOP_LENGTH
    padded = torch.nn.functional.pad(
        padded, (0, max(need - padded.shape[-1], 0)))
    rows = padded[..., :need].reshape(*lead, n_frames + 2, HOP_LENGTH)
    return torch.cat([rows[..., :n_frames, :], rows[..., 1: n_frames + 1, :],
                      rows[..., 2: n_frames + 2, : N_FFT - 2 * HOP_LENGTH]],
                     dim=-1)


def log_mel_spectrogram(audio, n_mels: int = 80) -> torch.Tensor:
    """16 kHz f32 PCM -> (n_mels, T//160) log-mel, whisper semantics.

    Accepts (T,) or batched (B, T), a tensor (the result lies on its
    device) or an array (the CPU). The normalization max is per sample
    over the full spectrogram. Inputs of at most 200 samples (below one
    centred STFT window) give the all-zero spectrogram."""
    audio = torch.as_tensor(audio)
    if audio.shape[-1] <= N_FFT // 2:
        shape = audio.shape[:-1] + (n_mels, audio.shape[-1] // HOP_LENGTH)
        return torch.zeros(shape, dtype=torch.float32, device=audio.device)
    return _log_mel_single(audio, n_mels)


def _log_mel_single(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """The reference's per-sample pipeline; a leading batch axis runs as
    one batched matmul, with the clamp's max taken per sample."""
    disable_tf32()
    cos_b, sin_b, mel_f = device_tables(_bases_and_bank, n_mels,
                                        audio.device)
    frames = frame_signal(audio.to(torch.float32))
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    log_spec = torch.log10(torch.clamp(power @ mel_f.T, min=1e-10))
    mx = torch.amax(log_spec, dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(-1, -2)   # (..., n_mels, n)


def log_mel_numpy_f64(audio: np.ndarray, n_mels: int = 80) -> np.ndarray:
    """float64 NumPy mirror of the pipeline — the algorithmic oracle
    (transformers' WhisperFeatureExtractor to ~1e-6); the f32 paths
    deviate from it only by float noise in near-zero spectral bins."""
    audio = np.asarray(audio, dtype=np.float64)
    pad = N_FFT // 2
    padded = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = audio.shape[0] // HOP_LENGTH
    idx = (np.arange(n_frames)[:, None] * HOP_LENGTH +
           np.arange(N_FFT)[None, :])
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT))
    power = np.abs(np.fft.rfft(padded[idx] * window, axis=1)) ** 2
    mel = power @ mel_filter_bank(n_mels).T.astype(np.float64)
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return (((log_spec + 4.0) / 4.0).T).astype(np.float32)


def _log10_mel_windows(frames: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(W, n_frames, n_fft) f32 framed windows -> un-normalized log10 mel
    (W, n_mels, n_frames). The clamp happens outside."""
    cos_b, sin_b, mel_f = device_tables(_bases_and_bank, n_mels,
                                        frames.device)
    frames = frames.to(torch.float32)
    re = frames @ cos_b
    im = frames @ sin_b
    power = re * re + im * im
    mel = power @ mel_f.T
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(-1, -2)


def log_mel_longform(audio: np.ndarray, n_mels: int = 80,
                     padding: int = N_SAMPLES, window_batch: int = 4,
                     device: Optional[torch.device] = None) -> np.ndarray:
    """Long-audio log-mel with whisper's *global* dynamic-range clamp
    (openai ``log_mel_spectrogram(audio, padding=N_SAMPLES)``). Framed on
    the host, fixed 30 s window batches through the DFT on ``device``.
    Returns (n_mels, len(audio)//160 + padding//160)."""
    device = torch.device("cpu") if device is None else torch.device(device)
    audio = np.asarray(audio, dtype=np.float32)
    if padding:
        audio = np.concatenate([audio, np.zeros(padding, np.float32)])
    n_frames = audio.shape[0] // HOP_LENGTH
    if n_frames == 0:
        return np.zeros((n_mels, 0), np.float32)
    pad = N_FFT // 2
    padded = np.pad(audio, (pad, pad), mode="reflect")

    frames_per_win = N_FRAMES
    n_windows = -(-n_frames // frames_per_win)
    logmels = []
    for w0 in range(0, n_windows, window_batch):
        wn = min(window_batch, n_windows - w0)
        idx = (np.arange(wn * frames_per_win)[:, None] * HOP_LENGTH +
               (w0 * frames_per_win * HOP_LENGTH) +
               np.arange(N_FFT)[None, :])
        idx = np.minimum(idx, padded.shape[0] - 1)  # zero tail guard
        frames = padded[idx].reshape(wn, frames_per_win, N_FFT)
        out = _log10_mel_windows(torch.from_numpy(frames).to(device),
                                 n_mels)
        logmels.append(out.cpu().numpy())
    log_spec = np.concatenate(logmels, axis=0)          # (W, n_mels, 3000)
    log_spec = np.concatenate(list(log_spec), axis=-1)  # (n_mels, total)
    log_spec = log_spec[:, :n_frames]
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def frame_window_np(audio: np.ndarray,
                    n_frames: int = N_FRAMES) -> np.ndarray:
    """Host-side framing of ONE window-length chunk into (n_frames, N_FFT)
    f32 — exactly ``log_mel_longform(audio, padding=n_frames*HOP)``'s first
    window (reflect left edge over the signal, zero right tail)."""
    audio = np.asarray(audio, dtype=np.float32)[
        : (n_frames - 1) * HOP_LENGTH + N_FFT]
    pad = N_FFT // 2
    if audio.shape[0] <= pad:   # sub-12.5 ms residue: zero-extend first
        audio = np.concatenate([audio,
                                np.zeros(pad + 1 - audio.shape[0],
                                         np.float32)])
    need = (n_frames - 1) * HOP_LENGTH + N_FFT
    left = audio[1: pad + 1][::-1]
    tail = np.zeros(max(need - pad - audio.shape[0], 0), np.float32)
    padded = np.concatenate([left, audio, tail])
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, N_FFT)[:: HOP_LENGTH][:n_frames]
    return np.ascontiguousarray(frames)


def log_mel_from_frames(frames: torch.Tensor, n_mels: int = 80,
                        n_frames: Optional[int] = None) -> torch.Tensor:
    """(B, n, N_FFT) pre-framed windows -> (B, n_mels, n_frames) normalized
    log-mel, numerically the first window of ``log_mel_longform``. Inputs
    with fewer than ``n_frames`` rows are zero-padded before the DFT."""
    if n_frames is not None and frames.shape[-2] < n_frames:
        frames = torch.nn.functional.pad(
            frames, (0, 0, 0, n_frames - frames.shape[-2]))
    log_spec = _log10_mel_windows(frames, n_mels)     # (B, n_mels, T)
    mx = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    return ((log_spec + 4.0) / 4.0).to(torch.float32)


def n_real_frames(n_samples: int, n_frames: int = N_FRAMES) -> int:
    """Number of leading :func:`frame_window_np` rows that can be nonzero
    for an ``n_samples`` chunk; every later row is exactly zero."""
    pad = N_FFT // 2
    n = min(max(n_samples, pad + 1), (n_frames - 1) * HOP_LENGTH + N_FFT)
    return int(min(n_frames, (pad + n - 1) // HOP_LENGTH + 2))


def pad_or_trim(audio: torch.Tensor, length: int = N_SAMPLES
                ) -> torch.Tensor:
    """Pad with zeros / trim to exactly ``length`` samples (last axis)."""
    t = audio.shape[-1]
    if t >= length:
        return audio[..., :length]
    return torch.nn.functional.pad(audio, (0, length - t))
