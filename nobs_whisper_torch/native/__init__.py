"""ctypes bindings for the native audio engine (audio_engine.cpp, shipped
inside this package; port of the JAX package's ``native/``).

The library is built at first use with g++ into ``build/`` next to the
source; when the package directory is read-only or no toolchain is
available, everything falls back to the NumPy implementations, so the
native path is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

log = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG_DIR, "audio_engine.cpp")


_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libnwt_audio.so")

_lib = None
_lib_lock = threading.Lock()


def _build() -> Optional[str]:
    if not os.path.exists(_SRC):
        log.warning("native source missing at %s; using NumPy fallback",
                    _SRC)
        return None
    src_mtime = os.path.getmtime(_SRC)
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= src_mtime):
        return _LIB_PATH
    # build under a per-process name, then rename: concurrent first users
    # (test workers, a server and its CLI) never load a half-written file
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired) as e:
        log.warning("native audio engine build failed (%s); "
                    "using NumPy fallback", e)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        path = _build()
        if path is None:
            _lib = False
            return None
        lib = ctypes.CDLL(path)
        c_f32p = ctypes.POINTER(ctypes.c_float)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.nwt_buffer_new.restype = ctypes.c_void_p
        lib.nwt_buffer_new.argtypes = [ctypes.c_int]
        lib.nwt_buffer_free.argtypes = [ctypes.c_void_p]
        lib.nwt_buffer_push.argtypes = [ctypes.c_void_p, c_f32p,
                                        ctypes.c_int64]
        lib.nwt_buffer_len.restype = ctypes.c_int64
        lib.nwt_buffer_len.argtypes = [ctypes.c_void_p]
        lib.nwt_buffer_noise_floor.restype = ctypes.c_double
        lib.nwt_buffer_noise_floor.argtypes = [ctypes.c_void_p]
        lib.nwt_buffer_last_speech_pos.restype = ctypes.c_int64
        lib.nwt_buffer_last_speech_pos.argtypes = [ctypes.c_void_p]
        lib.nwt_buffer_has_silence_boundary.restype = ctypes.c_int
        lib.nwt_buffer_has_silence_boundary.argtypes = [ctypes.c_void_p]
        for fn in (lib.nwt_buffer_take_silence_chunk,
                   lib.nwt_buffer_take_forced_chunk,
                   lib.nwt_buffer_take_all):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, c_f32p, ctypes.c_int64]
        lib.nwt_estimate_noise_floor.restype = ctypes.c_double
        lib.nwt_estimate_noise_floor.argtypes = [c_f32p, ctypes.c_int64,
                                                 ctypes.c_int]
        lib.nwt_find_silence_boundaries.restype = ctypes.c_int64
        lib.nwt_find_silence_boundaries.argtypes = [
            c_f32p, ctypes.c_int64, ctypes.c_int, c_i64p, ctypes.c_int64]
        lib.nwt_windowed_rms.argtypes = [c_f32p, ctypes.c_int64,
                                         ctypes.c_int, c_f32p,
                                         ctypes.c_int64]
        lib.nwt_resample.restype = ctypes.c_int64
        lib.nwt_resample.argtypes = [c_f32p, ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, c_f32p, ctypes.c_int64]
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeAudioBuffer:
    """Drop-in for audio.buffer.AudioBuffer backed by the C++ engine."""

    def __init__(self, sample_rate: int = 48_000):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native audio engine unavailable")
        self._lib = lib
        self.sample_rate = sample_rate
        self._h = lib.nwt_buffer_new(sample_rate)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.nwt_buffer_free(self._h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.nwt_buffer_len(self._h))

    @property
    def noise_floor(self) -> float:
        return float(self._lib.nwt_buffer_noise_floor(self._h))

    @property
    def last_speech_pos(self) -> int:
        return int(self._lib.nwt_buffer_last_speech_pos(self._h))

    def push_samples(self, samples: np.ndarray) -> None:
        x = np.ascontiguousarray(samples, np.float32).reshape(-1)
        self._lib.nwt_buffer_push(self._h, _fptr(x), x.size)

    def has_silence_boundary(self) -> bool:
        return bool(self._lib.nwt_buffer_has_silence_boundary(self._h))

    def _take(self, fn) -> Optional[np.ndarray]:
        # size-then-consume is not atomic: a concurrent push between the
        # two calls makes the consuming call return -1 (buffer grew past
        # the sized capacity). Retry with the fresh size instead of
        # silently reporting a full buffer as empty.
        for _ in range(8):
            need = fn(self._h, None, 0)
            if need <= 0:
                return None
            out = np.empty(need, np.float32)
            n = fn(self._h, _fptr(out), out.size)
            if n > 0:
                return out[:n]
            if n == 0:
                # the condition (e.g. the silence boundary) vanished
                # between probe and consume — the AudioBuffer contract
                # is None, never an empty chunk
                return None
        raise RuntimeError("native buffer kept growing during take()")

    def take_chunk_at_silence(self) -> Optional[np.ndarray]:
        return self._take(self._lib.nwt_buffer_take_silence_chunk)

    def take_forced_chunk(self) -> Optional[np.ndarray]:
        return self._take(self._lib.nwt_buffer_take_forced_chunk)

    def take(self) -> np.ndarray:
        out = self._take(self._lib.nwt_buffer_take_all)
        return out if out is not None else np.zeros(0, np.float32)

    def poll_chunk(self) -> Optional[np.ndarray]:
        chunk = self.take_chunk_at_silence()
        if chunk is not None:
            return chunk
        return self.take_forced_chunk()


def find_silence_boundaries_native(audio: np.ndarray,
                                   sample_rate: int = 16_000) -> List[int]:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native audio engine unavailable")
    x = np.ascontiguousarray(audio, np.float32)
    cap = 4096
    while True:
        bounds = np.zeros(cap, np.int64)
        n = lib.nwt_find_silence_boundaries(
            _fptr(x), x.size, sample_rate,
            bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bounds.size)
        if n < cap:
            return bounds[:n].tolist()
        # a full buffer means the C side STOPPED at the cap (it cannot
        # overflow) — the Python twin is unbounded, so grow and re-run
        # rather than silently dropping the tail's boundaries
        cap *= 4


def resample_native(audio: np.ndarray, in_rate: int,
                    out_rate: int = 16_000) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native audio engine unavailable")
    x = np.ascontiguousarray(audio, np.float32)
    need = lib.nwt_resample(_fptr(x), x.size, in_rate, out_rate, None, 0)
    out = np.empty(max(need, 0), np.float32)
    n = lib.nwt_resample(_fptr(x), x.size, in_rate, out_rate, _fptr(out),
                         out.size)
    return out[:n]


def make_audio_buffer(sample_rate: int = 48_000):
    """Factory: native buffer when the engine is built, NumPy otherwise."""
    if available():
        return NativeAudioBuffer(sample_rate)
    from ..audio.buffer import AudioBuffer
    return AudioBuffer(sample_rate)
