"""K14: the fused log-mel kernel (port of ``ops/mel_pallas.py``).

The reference's Pallas kernel (``log10_mel_pallas``, ``_mel_kernel``) runs
the audio front end of 30 s windows in one program per (window, block of
600 frames): reflect pad, the windowed DFT as three row-shifted f32
matmuls against cos/sin bases split into blocks of 160 taps (hop 160 and
width 400: frame i is rows i, i+1 and half of row i+2), power, the mel
filterbank and log10, with no intermediate in device memory. The clamp at
each sample's max - 8 needs the whole spectrogram, so it and the (x+4)/4
map run outside (:func:`log_mel_spectrogram_pallas`).

Here the kernel is ``csrc/mel.cu``, a real FFT of each frame read straight
from the (B, T) PCM; its source note says what bounds it on an H100 and
how the design answers that. It takes three tables from the host
(:func:`_kernel_tables`): the Hann window, twiddles and radix constants
(:func:`_fft_table`), each mel band's range of nonzero bins
(:func:`_band_ranges`) with the offset of its weights, and the
filterbank's nonzero weights band after band.
:func:`log10_mel_pallas` launches it for a CUDA tensor (or raises) and runs
:func:`log10_mel_pallas_plain`, the TPU kernel's steps (dense DFT bases) in
plain PyTorch, for a CPU tensor; ``k14_launch_count`` counts kernel
launches only. Nothing in the port's serving path calls K14, as in the
reference, where it is a drop-in for ``audio/mel.py::log_mel_spectrogram``
on 30 s windows.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.mel import _dft_bases_np, device_tables, mel_filter_bank
from ..core.config import HOP_LENGTH, N_FFT
from ..core.device import disable_tf32
from . import _build

FRAME_BLOCK = 600          # frames per grid cell of the TPU kernel
N_FREQ_PAD = 256           # 201 rfft bins zero-padded to 256
LANE_PAD = 256             # 160-sample hop rows zero-padded to 256 lanes

k14_launch_count = 0

_SIG = {"nwt_log10_mel": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_void_p]}

# csrc/mel.cu's table layout (floats): the Hann window; W400^(n2 k1) for
# k1 = 0..8, n2 = 0..24; W25^(p2 q1) for p2, q1 = 0..4; W16^j for j =
# 0..9 (each twiddle as re, im); cos, sin of 2 pi / 5 and of 4 pi / 5
TAB_HANN, TAB_W400, TAB_W25, TAB_W16, TAB_W5, TAB_SIZE = (
    0, 400, 850, 900, 920, 924)
# the filterbank's nonzero weights the kernel stages (each bin feeds at
# most two triangular bands)
MEL_MAX_NNZ = 416


@functools.lru_cache(maxsize=4)
def _padded_tables(n_mels: int):
    """The DFT bases split into 3 row blocks of 160 taps (block 2 holds
    taps 320-399, zero-padded), each (LANE_PAD, N_FREQ_PAD), and the
    zero-padded (N_FREQ_PAD, n_mels) mel filterbank, as numpy f32."""
    cos_b, sin_b = _dft_bases_np(N_FFT)             # (400, 201)

    def split(b):
        out = np.zeros((3, LANE_PAD, N_FREQ_PAD), np.float32)
        out[0, :160, :201] = b[0:160]
        out[1, :160, :201] = b[160:320]
        out[2, :80, :201] = b[320:400]
        return out

    melf = np.zeros((N_FREQ_PAD, n_mels), np.float32)
    melf[:201] = mel_filter_bank(n_mels).T          # (201, n_mels)
    return split(cos_b), split(sin_b), melf


def _twiddles(n: int, a: np.ndarray) -> np.ndarray:
    """W_n^a = e^(-2 pi i a / n) in float64, as (..., 2) re, im."""
    ang = -2.0 * np.pi * a / n
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


@functools.lru_cache(maxsize=1)
def _fft_table() -> np.ndarray:
    """K14's FFT constants (``TAB_*`` layout), computed in float64 and
    rounded to f32 once, as ``audio/mel.py::_dft_bases_np`` rounds the
    reference's bases: the periodic Hann window of 400 taps; the 16 x 25
    split's twiddles W400^(n2 k1); the 5 x 5 split's W25^(p2 q1); the
    16-point DFT's W16^j; the radix-5 constants."""
    t = np.zeros(TAB_SIZE, np.float64)
    n = np.arange(N_FFT)
    t[TAB_HANN:TAB_W400] = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    t[TAB_W400:TAB_W25] = _twiddles(
        N_FFT, np.arange(9)[:, None] * np.arange(25)[None, :]).ravel()
    t[TAB_W25:TAB_W16] = _twiddles(
        25, np.arange(5)[:, None] * np.arange(5)[None, :]).ravel()
    t[TAB_W16:TAB_W5] = _twiddles(16, np.arange(10)).ravel()
    t[TAB_W5:] = (np.cos(2 * np.pi / 5), np.sin(2 * np.pi / 5),
                  np.cos(4 * np.pi / 5), np.sin(4 * np.pi / 5))
    return t.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _band_ranges(n_mels: int) -> np.ndarray:
    """(n_mels, 2) int32: the first and last nonzero bin of each mel band
    of ``mel_filter_bank`` (a triangle, so its nonzeros are one range);
    (1, 0) for a band with none."""
    nz = mel_filter_bank(n_mels) > 0                # (n_mels, 201)
    lo = np.argmax(nz, axis=1)
    hi = nz.shape[1] - 1 - np.argmax(nz[:, ::-1], axis=1)
    empty = ~nz.any(axis=1)
    lo[empty], hi[empty] = 1, 0
    for m in np.flatnonzero(~empty):
        assert nz[m, lo[m]: hi[m] + 1].all(), m
    return np.stack([lo, hi], axis=1).astype(np.int32)


def _kernel_tables(n_mels: int):
    """What ``nwt_log10_mel`` reads besides the PCM, as numpy: the FFT
    table; (n_mels, 3) int32 bands, each band's first and last nonzero bin
    and the offset of its weights; the filterbank's nonzero weights band
    after band, (MEL_MAX_NNZ,) f32 zero-padded."""
    melf = mel_filter_bank(n_mels)
    rng = _band_ranges(n_mels)
    width = np.maximum(rng[:, 1] - rng[:, 0] + 1, 0)
    off = np.concatenate([[0], np.cumsum(width)[:-1]])
    assert width.sum() <= MEL_MAX_NNZ, width.sum()
    wts = np.zeros(MEL_MAX_NNZ, np.float32)
    for m, (lo, hi) in enumerate(rng):
        wts[off[m]: off[m] + width[m]] = melf[m, lo: hi + 1]
    bands = np.concatenate([rng, off[:, None]], axis=1).astype(np.int32)
    return _fft_table(), bands, wts


def _check_frames(t: int) -> int:
    n_frames = t // HOP_LENGTH
    if n_frames % FRAME_BLOCK:
        raise ValueError(f"frames {n_frames} not a multiple of {FRAME_BLOCK}")
    return n_frames


def _rows(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T) -> the reflect-padded signal zero-extended to
    (n_frames + 8) rows of 160 samples, (B, n_frames + 8, 160) f32."""
    pad = N_FFT // 2
    b = audio.shape[0]
    padded = torch.nn.functional.pad(audio.to(torch.float32)[:, None],
                                     (pad, pad), mode="reflect")[:, 0]
    need = (n_frames + 8) * HOP_LENGTH
    padded = torch.nn.functional.pad(
        padded, (0, max(need - padded.shape[1], 0)))
    return padded[:, :need].reshape(b, n_frames + 8, HOP_LENGTH)


def log10_mel_pallas_plain(audio: torch.Tensor, n_mels: int = 80
                           ) -> torch.Tensor:
    """Plain PyTorch K14, the kernel's steps in f32 (TF32 off): rows of
    160 padded to 256 lanes; re and im each (P0 + P1) + P2, where Pk is
    the rows shifted by k times block k of the split basis; power, the
    filterbank, log10(max(., 1e-10)). (B, T) -> (B, n_frames, n_mels)."""
    disable_tf32()
    n_frames = _check_frames(audio.shape[1])
    dev = audio.device
    rows = torch.nn.functional.pad(_rows(audio, n_frames),
                                   (0, LANE_PAD - HOP_LENGTH))
    cosp, sinp, melf = device_tables(_padded_tables, n_mels, dev)

    def dft(basis):
        acc = rows[:, :n_frames] @ basis[0]
        for k in (1, 2):
            acc = acc + rows[:, k: k + n_frames] @ basis[k]
        return acc

    re, im = dft(cosp), dft(sinp)
    power = re * re + im * im
    return torch.log10(torch.clamp(power @ melf, min=1e-10))


def log10_mel_pallas(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """K14: (B, T) 16 kHz PCM -> (B, n_frames, n_mels) un-normalized
    log10 mel. T // 160 must be a multiple of 600 (a 30 s window is 5
    blocks); the kernel applies the reflect pad as it reads the PCM."""
    global k14_launch_count
    n_frames = _check_frames(audio.shape[1])
    if audio.device.type == "cpu":
        return log10_mel_pallas_plain(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    from . import _build
    lib = _build.load("mel", _SIG)
    dev = audio.device
    b, t = audio.shape
    pcm = audio.to(torch.float32).contiguous()
    tab, bands, wts = device_tables(_kernel_tables, n_mels, dev)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=dev)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = lib.nwt_log10_mel(
        ptr(pcm), ptr(tab), ptr(bands), ptr(wts), ptr(out), b, t, n_frames,
        n_mels, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "log10_mel")
    with _build.COUNT_LOCK:
        k14_launch_count += 1
    return out


def log_mel_spectrogram_pallas(audio: torch.Tensor, n_mels: int = 80
                               ) -> torch.Tensor:
    """Drop-in for ``audio/mel.py::log_mel_spectrogram`` on 30 s windows:
    (T,) or (B, T) -> (n_mels, n_frames) or (B, n_mels, n_frames),
    whisper-normalized outside the kernel."""
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    log_spec = log10_mel_pallas(audio.to(torch.float32), n_mels)
    mx = torch.amax(log_spec, dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, mx - 8.0)
    out = ((log_spec + 4.0) / 4.0).transpose(1, 2)
    return out[0] if squeeze else out
