"""Audio ingestion: WAV/PCM readers and stream iterators.

Replaces the reference's cpal/CoreAudio capture layer (SURVEY.md §2.2):
TPU hosts have no microphone, so ingestion means files, raw PCM blobs, or
iterators feeding the streaming ``AudioBuffer``. Pure stdlib + NumPy.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Iterator, Optional, Tuple, Union

import numpy as np

from ..core.config import SAMPLE_RATE


def read_wav(path_or_bytes: Union[str, bytes]) -> Tuple[np.ndarray, int]:
    """WAV -> (mono float32 in [-1, 1], sample_rate). Supports 8/16/24/32-bit
    PCM and 32-bit float; multi-channel is averaged to mono (the reference
    forces mono capture, src-tauri/src/audio.rs:263-296)."""
    src = (io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes)
           else path_or_bytes)
    try:
        with wave.open(src, "rb") as w:
            rate = w.getframerate()
            n_ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    except (wave.Error, EOFError):
        # EOFError: the stdlib module raises it on files truncated
        # mid-header; fall through to the RIFF parser, which reports a
        # clean ValueError
        # stdlib wave rejects WAVE_FORMAT_IEEE_FLOAT (format tag 3,
        # e.g. ffmpeg -c:a pcm_f32le output) — parse the RIFF chunks
        # ourselves for that case
        blob = (path_or_bytes if isinstance(path_or_bytes, bytes)
                else open(path_or_bytes, "rb").read())
        return _read_float_wav(blob)

    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # heuristically treat as int32 PCM; float WAVs need the fmt tag,
        # which the wave module hides — int32 covers the common case
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8) |
             (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32)
        x /= float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")

    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x.astype(np.float32), rate


def _read_float_wav(blob: bytes) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser for IEEE-float WAVs (format tag 3), which the
    stdlib wave module refuses to open."""
    import struct
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, n = 12, len(blob)
    fmt = None
    fmt_body = b""
    data = None
    while pos + 8 <= n:
        cid = blob[pos:pos + 4]
        (size,) = struct.unpack("<I", blob[pos + 4:pos + 8])
        body = blob[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("WAV fmt chunk truncated")
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)          # chunks are word-aligned
    if fmt is None or data is None:
        raise ValueError("WAV missing fmt/data chunk")
    tag, n_ch, rate, _, _, bits = fmt
    if tag == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the REAL format is the SubFormat GUID
        # in the fmt extension (first 2 bytes = the classic tag) — a
        # 32-bit extensible file can be integer PCM, and reading its
        # bytes as f32 would silently return garbage audio
        if len(fmt_body) >= 26:
            (tag,) = struct.unpack("<H", fmt_body[24:26])
        else:
            raise ValueError("extensible WAV without a SubFormat GUID")
    if tag == 1:                               # integer PCM subtype
        if bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        else:
            raise ValueError(f"unsupported extensible PCM width {bits}")
    elif tag == 3:
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(
            np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {tag}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch).mean(axis=1)
    return x.astype(np.float32), rate


def write_wav(path, audio: np.ndarray,
              sample_rate: int = SAMPLE_RATE) -> None:
    """``path``: filename or a binary file-like (wave.open takes
    both — the SDK encodes request bodies through a BytesIO here)."""
    audio = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm = (audio * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def read_pcm_f32(path_or_bytes: Union[str, bytes],
                 sample_rate: int = SAMPLE_RATE) -> Tuple[np.ndarray, int]:
    """Raw little-endian float32 PCM blob."""
    if isinstance(path_or_bytes, bytes):
        raw = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as f:
            raw = f.read()
    return np.frombuffer(raw, "<f4").astype(np.float32), sample_rate


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch on extension: .wav, .flac, or raw .pcm/.f32."""
    lower = path.lower()
    if lower.endswith(".wav"):
        return read_wav(path)
    if lower.endswith(".flac"):
        from .flac import read_flac
        return read_flac(path)
    if lower.endswith((".pcm", ".f32", ".raw")):
        return read_pcm_f32(path)
    raise ValueError(f"unsupported audio format: {path}")


def stream_frames(audio: np.ndarray, frame_ms: int = 10,
                  sample_rate: int = SAMPLE_RATE) -> Iterator[np.ndarray]:
    """Replay an array as a real-time-style frame stream (the shape of the
    reference's ~10 ms cpal callbacks, src-tauri/src/state.rs:585)."""
    n = sample_rate * frame_ms // 1000
    for i in range(0, len(audio), n):
        yield audio[i: i + n]


def stereo_to_mono(frames: np.ndarray, n_channels: int) -> np.ndarray:
    """Interleaved multi-channel -> mono average (state.rs:588-595)."""
    if n_channels <= 1:
        return np.asarray(frames, np.float32)
    x = np.asarray(frames, np.float32)
    usable = (x.size // n_channels) * n_channels
    return x[:usable].reshape(-1, n_channels).mean(axis=1)
