"""Native C++ audio engine: build, and decision-level equivalence with the
NumPy implementations on the reference's synthetic scenarios."""

import numpy as np
import pytest
import torch

from nobs_whisper_torch import native
from nobs_whisper_torch.audio.buffer import AudioBuffer
from nobs_whisper_torch.audio.resample import resample
from nobs_whisper_torch.audio.vad import (estimate_noise_floor,
                                          find_silence_boundaries)

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

SR = 16000

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def sine(duration_s, freq=440.0, amp=0.3, sr=SR):
    t = np.arange(int(duration_s * sr)) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def noise(duration_s, amp=0.002, sr=SR, seed=0):
    rng = np.random.RandomState(seed)
    return (amp * rng.randn(int(duration_s * sr))).astype(np.float32)


def silence(duration_s, sr=SR):
    return np.zeros(int(duration_s * sr), np.float32)


def test_native_builds():
    assert native.get_lib() is not None


def test_noise_floor_matches_python():
    audio = np.concatenate([noise(0.5, seed=42), sine(2.0)])
    py = estimate_noise_floor(audio, SR)
    nat = native.get_lib()
    import ctypes
    got = nat.nwt_estimate_noise_floor(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        audio.size, SR)
    assert got == pytest.approx(py, rel=1e-5)


def test_silence_boundaries_match_python():
    audio = np.concatenate([
        noise(0.5, seed=42), sine(2.0), silence(1.0), sine(2.0),
        silence(1.0), sine(2.0)])
    py = find_silence_boundaries(audio, SR)
    nat = native.find_silence_boundaries_native(audio, SR)
    assert nat == py
    assert len(nat) == 2


def test_buffer_chunking_matches_python():
    data = [sine(2.0), silence(1.0), sine(1.0)]
    pybuf = AudioBuffer(SR)
    natbuf = native.NativeAudioBuffer(SR)
    for d in data:
        pybuf.push_samples(d)
        natbuf.push_samples(d)
    assert len(pybuf) == len(natbuf)
    assert natbuf.noise_floor == pytest.approx(pybuf.noise_floor, rel=1e-4)
    assert natbuf.has_silence_boundary() == pybuf.has_silence_boundary()
    a = pybuf.take_chunk_at_silence()
    b = natbuf.take_chunk_at_silence()
    assert (a is None) == (b is None)
    if a is not None:
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b)
    # residues equal
    np.testing.assert_allclose(pybuf.take(), natbuf.take())


def test_buffer_forced_split_matches_python():
    audio = np.concatenate([sine(24.0), sine(0.5, amp=0.01), sine(1.5)])
    pybuf = AudioBuffer(SR)
    natbuf = native.NativeAudioBuffer(SR)
    pybuf.push_samples(audio)
    natbuf.push_samples(audio)
    a = pybuf.take_forced_chunk()
    b = natbuf.take_forced_chunk()
    assert a is not None and b is not None
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b)


def test_native_resample_matches_scipy_tone():
    audio = sine(1.0, freq=440, sr=48000)
    ref = resample(audio, 48000, 16000)
    got = native.resample_native(audio, 48000, 16000)
    assert abs(len(got) - len(ref)) <= 2
    n = min(len(got), len(ref))
    assert np.abs(got[200:n - 200] - ref[200:n - 200]).max() < 0.02


def test_factory():
    buf = native.make_audio_buffer(SR)
    buf.push_samples(sine(0.5))
    assert len(buf) == SR // 2


def test_session_uses_native_buffer_when_available():
    """The C++ engine is the PRODUCTION buffer: StreamingSession must
    construct it (not the NumPy twin) whenever the library builds."""
    from nobs_whisper_torch import native
    from nobs_whisper_torch.pipeline.session import (SessionConfig,
                                                     StreamingSession)
    if not native.available():
        import pytest
        pytest.skip("native engine not built here")

    class NullEngine:
        def transcribe(self, *a, **kw):
            class R:
                text = ""
                segments = []
                language = "en"
            return R()

    s = StreamingSession(NullEngine(), SessionConfig())
    assert s.start()
    try:
        assert isinstance(s._buffer, native.NativeAudioBuffer)
    finally:
        s.cancel()


def _poll_all(buf, pushes):
    """Push each array, polling once after each (the session's push path);
    returns every polled chunk (None where none was ready) and the
    residue."""
    out = []
    for p in pushes:
        buf.push_samples(p)
        out.append(buf.poll_chunk())
    return out, buf.take()


@pytest.mark.parametrize("rate,seed,step", [(48000, 1, 24000),
                                            (48000, 4, 4801),
                                            (16000, 2, 8000),
                                            (16000, 3, 160)])
def test_buffers_bit_equal_across_packages(rate, seed, step):
    """The port's native buffer, its NumPy ``AudioBuffer`` and the JAX
    package's two buffers, fed the same pushes of speech-like audio (a
    silence-split and a forced 25 s split among them), poll the same
    chunks bit for bit and keep the same residue."""
    from nobs_whisper_torch.utils.testing import speech_like_audio
    from nobs_whisper_tpu import native as ref_native
    from nobs_whisper_tpu.audio.buffer import AudioBuffer as RefBuffer
    audio = np.concatenate([speech_like_audio(20.0, seed=seed,
                                              sample_rate=rate),
                            sine(27.0, sr=rate)])
    pushes = [audio[i:i + step] for i in range(0, len(audio), step)]
    bufs = [native.NativeAudioBuffer(rate), AudioBuffer(rate),
            RefBuffer(rate)]
    if ref_native.available():
        bufs.append(ref_native.NativeAudioBuffer(rate))
    (want, want_rest), *others = [_poll_all(b, pushes) for b in bufs]
    assert sum(c is not None for c in want) >= 2
    for got, rest in others:
        assert [c is None for c in got] == [c is None for c in want]
        for a, b in zip(got, want):
            assert a is None or (a.dtype == b.dtype
                                 and np.array_equal(a, b))
        assert np.array_equal(rest, want_rest)
