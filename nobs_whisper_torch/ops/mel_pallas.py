"""K14: the fused log-mel kernel (port of ``ops/mel_pallas.py``).

The reference's Pallas kernel (``log10_mel_pallas``, ``_mel_kernel``) runs
the audio front end of 30 s windows in one program per (window, block of
600 frames): reflect pad, the windowed DFT as three row-shifted f32
matmuls against cos/sin bases split into blocks of 160 taps (hop 160 and
width 400: frame i is rows i, i+1 and half of row i+2), power, the mel
filterbank and log10, with no intermediate in device memory. The clamp at
each sample's max - 8 needs the whole spectrogram, so it and the (x+4)/4
map run outside (:func:`log_mel_spectrogram_pallas`).

Here the kernel is ``csrc/mel.cu``, whose source note says what bounds it
on an H100 and how the design answers that. :func:`log10_mel_pallas`
launches it for a CUDA tensor (or raises) and runs
:func:`log10_mel_pallas_plain`, the kernel's steps in plain PyTorch, for a
CPU tensor; ``k14_launch_count`` counts kernel launches only. Nothing in
the port's serving path calls K14, as in the reference, where it is a
drop-in for ``audio/mel.py::log_mel_spectrogram`` on 30 s windows.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..audio.mel import _dft_bases_np, device_tables, mel_filter_bank
from ..core.config import HOP_LENGTH, N_FFT
from ..core.device import disable_tf32

FRAME_BLOCK = 600          # frames per grid cell of the TPU kernel
N_FREQ_PAD = 256           # 201 rfft bins zero-padded to 256
LANE_PAD = 256             # 160-sample hop rows zero-padded to 256 lanes

k14_launch_count = 0

_SIG = {"nwt_log10_mel": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
        + [ctypes.c_void_p]}


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
    blocks); the reflect pad is applied here."""
    global k14_launch_count
    n_frames = _check_frames(audio.shape[1])
    if audio.device.type == "cpu":
        return log10_mel_pallas_plain(audio, n_mels)
    if audio.device.type != "cuda":
        raise ValueError(f"unsupported device {audio.device}")
    from . import _build
    lib = _build.load("mel", _SIG)
    dev = audio.device
    b = audio.shape[0]
    rows = _rows(audio, n_frames).contiguous()
    cosp, sinp, melf = device_tables(_padded_tables, n_mels, dev)
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=dev)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = lib.nwt_log10_mel(
        ptr(rows), ptr(cosp), ptr(sinp), ptr(melf), ptr(out), b, n_frames,
        n_mels, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "log10_mel")
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
