"""The raw-PCM log-mel path and K14 on the CPU, against the JAX package.

``audio/mel.py::log_mel_spectrogram`` (and ``frame_signal``,
``_log_mel_single``, the f64 oracle ``log_mel_numpy_f64``) against the
reference's, and K14's plain version (``ops/mel_pallas.py::
log10_mel_pallas_plain``, what the wrapper runs on a CPU tensor) against
the Pallas kernel in interpret mode. Inputs are made with numpy from a
seed and cross as numpy arrays; the kernel itself runs on the card
(tests/test_torch_kernels_gpu.py).

Tolerances, each with its reason:

* The port's ``log_mel_spectrogram`` against the reference's: 1e-4 on the
  normalized output, the bound ``tests/test_mel_pallas.py`` holds the
  Pallas kernel to (readings: at most 3.6e-5; both are f32 matmuls that
  sum in their own orders).
* Against the f64 oracle: the reference's own bounds (mean < 2e-4, max
  < 0.03, ``tests/test_mel.py:48-57``); batched against singles 1e-6.
* K14's plain version against the Pallas kernel: 1e-5 on the normalized
  output, and on the un-normalized log10 only where it lies above each
  sample's max - 8 (below it, the log10 of near-zero bins depends on the
  order of the f32 sums; the clamp hides them). Readings: at most 1e-6.
* K14's plain version against the port's ``log_mel_spectrogram``: 1e-4,
  as ``tests/test_mel_pallas.py:15-33`` holds the kernel to the reference.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nobs_whisper_tpu.audio import mel as jm
from nobs_whisper_tpu.ops import mel_pallas as jp
from nobs_whisper_torch.audio import mel as tm
from nobs_whisper_torch.ops import mel_pallas as tp
from nobs_whisper_torch.utils.testing import sine_audio, speech_like_audio

REF_TOL = dict(rtol=1e-4, atol=1e-4)
K14_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pad30(a):
    return np.array(jm.pad_or_trim(a))


def _batch():
    """B = 2: 5 s of speech-like noise and 3 s of a 500 Hz sine, each
    padded to 30 s."""
    return np.stack([_pad30(speech_like_audio(5.0, seed=1)),
                     _pad30(sine_audio(3.0, freq=500))])


def _single():
    return _pad30(speech_like_audio(2.0, seed=3))


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_spectrogram_matches_reference(n_mels, batched):
    audio = _batch() if batched else _single()
    want = np.asarray(jm.log_mel_spectrogram(jnp.asarray(audio), n_mels))
    got = tm.log_mel_spectrogram(torch.from_numpy(audio), n_mels)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)


def test_frame_signal_matches_reference():
    audio = speech_like_audio(1.3, seed=2)
    want = np.asarray(jm.frame_signal(jnp.asarray(audio)))
    got = tm.frame_signal(torch.from_numpy(audio)).numpy()
    np.testing.assert_array_equal(got, want)
    batched = tm.frame_signal(torch.from_numpy(np.stack([audio, audio[::-1]
                                                         .copy()])))
    np.testing.assert_array_equal(batched[0].numpy(), want)


@pytest.mark.parametrize("shape,n_mels", [((0,), 128), ((180,), 128),
                                          ((2, 100), 128), ((200,), 80)])
def test_short_inputs_give_zeros(shape, n_mels):
    """Inputs of at most 200 samples (below one centred STFT window) give
    the reference's all-zero (..., n_mels, T // 160) result
    (``tests/test_audio.py:328-333``)."""
    audio = np.zeros(shape, np.float32)
    want = np.asarray(jm.log_mel_spectrogram(jnp.asarray(audio), n_mels))
    got = tm.log_mel_spectrogram(torch.from_numpy(audio), n_mels)
    assert tuple(got.shape) == want.shape
    assert got.dtype == torch.float32
    assert not got.any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_log_mel_matches_f64_oracle(n_mels):
    audio = _pad30(speech_like_audio(4.0, seed=7))
    oracle = tm.log_mel_numpy_f64(audio, n_mels)
    np.testing.assert_allclose(
        oracle, jm.log_mel_numpy_f64(audio, n_mels), rtol=0, atol=0)
    err = np.abs(tm.log_mel_spectrogram(audio, n_mels).numpy() - oracle)
    assert err.mean() < 2e-4
    assert err.max() < 0.03


def test_log_mel_batched_matches_single():
    audio = np.stack([_pad30(sine_audio(2.0, 300)),
                      _pad30(speech_like_audio(3.0))])
    batched = tm.log_mel_spectrogram(torch.from_numpy(audio)).numpy()
    singles = np.stack([tm.log_mel_spectrogram(torch.from_numpy(a)).numpy()
                        for a in audio])
    np.testing.assert_allclose(batched, singles, rtol=1e-6, atol=1e-6)


def test_padded_tables_match_reference():
    for n_mels in (80, 128):
        for got, want in zip(tp._padded_tables(n_mels),
                             jp._padded_tables(n_mels)):
            np.testing.assert_array_equal(got, want)
    assert tp.FRAME_BLOCK == jp.FRAME_BLOCK


def _above_clamp(got, want):
    """Un-normalized log10 held only above each sample's max - 8."""
    keep = want > want.max(axis=(1, 2), keepdims=True) - 8.0
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], **K14_TOL)


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_plain_matches_pallas_interpret(n_mels, batched):
    audio = _batch() if batched else _single()[None]
    want = np.asarray(jp.log10_mel_pallas(jnp.asarray(audio), n_mels,
                                          interpret=True))
    got = tp.log10_mel_pallas(torch.from_numpy(audio), n_mels)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _above_clamp(got.numpy(), want)

    src = audio if batched else audio[0]
    want_n = np.asarray(jp.log_mel_spectrogram_pallas(
        jnp.asarray(src), n_mels, interpret=True))
    got_n = tp.log_mel_spectrogram_pallas(torch.from_numpy(src), n_mels)
    assert tuple(got_n.shape) == want_n.shape
    np.testing.assert_allclose(got_n.numpy(), want_n, **K14_TOL)


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_plain_matches_log_mel_spectrogram(n_mels, batched):
    audio = torch.from_numpy(_batch() if batched else _single())
    want = tm.log_mel_spectrogram(audio, n_mels).numpy()
    got = tp.log_mel_spectrogram_pallas(audio, n_mels).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **REF_TOL)


def test_k14_rejects_non_block_multiple():
    bad = torch.zeros((1, (tp.FRAME_BLOCK + 1) * 160))
    with pytest.raises(ValueError, match="not a multiple"):
        tp.log_mel_spectrogram_pallas(bad, 80)
    with pytest.raises(ValueError, match="not a multiple"):
        tp.log10_mel_pallas(bad, 80)


def test_k14_not_on_serving_paths(monkeypatch, tmp_path):
    """K14 is a drop-in the port's serving path does not take, as in the
    reference: the window program (through the batcher) and
    ``transcribe`` call neither its wrapper nor its plain version, and
    its launch counter stays 0. A direct call is counted (the spy
    works)."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import (KernelSpies,
                                                  write_tiny_checkpoint)
    path = str(tmp_path / "m.bin")
    write_tiny_checkpoint(path)
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    spies = KernelSpies(monkeypatch.setattr, kernels=("K14",))
    wrapper_calls = []
    real = tp.log10_mel_pallas
    monkeypatch.setattr(tp, "log10_mel_pallas",
                        lambda *a, **k: wrapper_calls.append(1) or real(*a,
                                                                        **k))
    audio = speech_like_audio(1.5, seed=5)
    assert eng.transcribe(audio, language="en").segments is not None
    be = BatchedEngine(eng, max_batch=2)
    try:
        assert be.transcribe(audio, language="en").segments is not None
    finally:
        be.close()
    assert spies.calls["K14"] == 0 and not wrapper_calls
    assert tp.k14_launch_count == 0
    tp.log_mel_spectrogram_pallas(torch.zeros(tp.FRAME_BLOCK * 160), 80)
    assert spies.calls["K14"] == 1
