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


# ---------------------------------------------------------------------------
# K14's host tables and its FFT plan (csrc/mel.cu), checked without a card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_band_ranges_cover_the_filterbank_nonzeros(n_mels):
    """Each band's (lo, hi) is exactly the set of nonzero bins of that
    band's column of the reference's padded filterbank (a triangle: one
    contiguous range), so the kernel's sparse sum drops only products by
    +0."""
    melf = tp._padded_tables(n_mels)[2]             # (256, n_mels)
    bands = tp._band_ranges(n_mels)
    assert bands.shape == (n_mels, 2) and bands.dtype == np.int32
    for m in range(n_mels):
        nz = np.flatnonzero(melf[:, m])
        lo, hi = bands[m]
        assert nz.size and (lo, hi) == (nz[0], nz[-1])
        assert nz.size == hi - lo + 1
    _, kb, wts = tp._kernel_tables(n_mels)
    np.testing.assert_array_equal(kb[:, :2], bands)
    for m, (lo, hi, off) in enumerate(kb):           # the weights it stages
        np.testing.assert_array_equal(wts[off: off + hi - lo + 1],
                                      melf[lo: hi + 1, m])
    assert not wts[kb[-1, 2] + kb[-1, 1] - kb[-1, 0] + 1:].any()


def test_k14_fft_table_layout_matches_the_kernel():
    """The table's offsets and the staged weights' size in
    ``ops/mel_pallas.py`` are the ones ``csrc/mel.cu`` reads, and the
    table's entries are the float64 values rounded once to f32."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(tp.__file__), os.pardir, "csrc",
                            "mel.cu")).read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    for name in ("TAB_HANN", "TAB_W400", "TAB_W25", "TAB_W16", "TAB_W5",
                 "TAB_SIZE", "MEL_MAX_NNZ"):
        assert int(consts[name]) == getattr(tp, name), name
    tab = tp._fft_table()
    assert tab.dtype == np.float32 and tab.shape == (tp.TAB_SIZE,)
    n = np.arange(400)
    np.testing.assert_array_equal(
        tab[:400], (0.5 * (1 - np.cos(2 * np.pi * n / 400))).astype(np.float32))
    w = tab[tp.TAB_W400:tp.TAB_W25].reshape(9, 25, 2)
    k1, n2 = 7, 13
    assert w[k1, n2, 0] == np.float32(np.cos(-2 * np.pi * n2 * k1 / 400))
    assert w[k1, n2, 1] == np.float32(np.sin(-2 * np.pi * n2 * k1 / 400))


def _k14_fft_model(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """csrc/mel.cu's plan in numpy f32, reading the tables the wrapper
    uploads (``_kernel_tables``) at the offsets the kernel reads: the
    reflect pad by index, the window, the 16 x 25 split (a real 16-point
    DFT as radix 4 x 4 and the W400 twiddles; a 25-point DFT as radix 5 x
    5 with the W25 twiddles), each bin's power from the output that owns
    it, the band ranges' sums in increasing k and log10. (B, T) ->
    (B, n_frames, n_mels)."""
    tab, bands, wts = tp._kernel_tables(n_mels)
    f32, c64 = np.float32, np.complex64
    b, t = audio.shape
    n_frames = t // 160
    a = (np.arange(n_frames)[:, None] * 160 + np.arange(400)[None, :]
         - 200)
    idx = np.where(a < 0, -a, np.where(a < t, a, 2 * t - 2 - a))
    x = np.where(a < t + 200, audio[:, np.clip(idx, 0, t - 1)], 0)
    xw = (x.astype(f32) * tab[tp.TAB_HANN:tp.TAB_W400]).reshape(
        b, n_frames, 16, 25)                        # [n1][n2]
    cplx = lambda o, n: (tab[o:o + 2 * n:2] + 1j * tab[o + 1:o + 2 * n:2]
                         ).astype(c64)
    w400 = cplx(tp.TAB_W400, 225).reshape(9, 25)
    w25 = cplx(tp.TAB_W25, 25).reshape(5, 5)
    w16 = cplx(tp.TAB_W16, 10)
    c1, s1, c2, s2 = tab[tp.TAB_W5:tp.TAB_SIZE]
    # radix 4 over n1 = 4 m1 + m2: the real 4-point DFTs, then W16
    a_, b_, c_, d_ = (xw[:, :, 4 * m1:4 * m1 + 4] for m1 in range(4))
    s, u2 = (a_ + c_) + (b_ + d_), (a_ + c_) - (b_ + d_)
    u1 = ((a_ - c_) + 1j * (d_ - b_)).astype(c64)
    y = np.zeros((b, n_frames, 9, 25), c64)
    y[:, :, 0] = (s[:, :, 0] + s[:, :, 2]) + (s[:, :, 1] + s[:, :, 3])
    y[:, :, 8] = (s[:, :, 0] + s[:, :, 2]) - (s[:, :, 1] + s[:, :, 3])
    y[:, :, 4] = (s[:, :, 0] - s[:, :, 2]) + 1j * (s[:, :, 3] - s[:, :, 1])

    def comb(v, k1a):
        y[:, :, k1a] = (v[0] + v[2]) + (v[1] + v[3])
        y[:, :, k1a + 4] = (v[0] - v[2]) - 1j * (v[1] - v[3])

    comb([u1[:, :, m] * w16[m] if m else u1[:, :, 0] for m in range(4)], 1)
    comb([u2[:, :, m] * w16[2 * m] if m else u2[:, :, 0] + 0j
          for m in range(4)], 2)
    cu = np.conj(u1)
    comb([cu[:, :, m] * w16[3 * m] if m else cu[:, :, 0] for m in range(4)],
         3)
    z = (y * w400).astype(c64).reshape(b, n_frames, 9, 5, 5)   # [p1][p2]

    def dft5(x0, x1, x2, x3, x4):
        t1, t2, t3, t4 = x1 + x4, x2 + x3, x1 - x4, x2 - x3
        b1, b2 = x0 + c1 * t1 + c2 * t2, x0 + c2 * t1 + c1 * t2
        e1, e2 = s1 * t3 + s2 * t4, s2 * t3 - s1 * t4
        return [x0 + (t1 + t2), b1 - 1j * e1, b2 - 1j * e2, b2 + 1j * e2,
                b1 + 1j * e1]

    g = np.stack(dft5(*(z[:, :, :, p1] for p1 in range(5))), 3)  # [q1][p2]
    g = (g * w25.T).astype(c64)                     # W25^(p2 q1)
    xk = np.stack(dft5(*(g[..., p2] for p2 in range(5))), 4)     # [q1][q2]
    power = np.zeros((b, n_frames, 201), f32)
    for k1 in range(9):
        for q1 in range(5):
            for q2 in range(5):
                k = k1 + 16 * (q1 + 5 * q2)
                v = xk[:, :, k1, q1, q2]
                pv = v.real.astype(f32) ** 2 + v.imag.astype(f32) ** 2
                if k <= 200:
                    power[:, :, k] = pv
                elif 0 < k1 < 8:
                    power[:, :, 400 - k] = pv
    mel = np.zeros((b, n_frames, n_mels), f32)
    for m, (lo, hi, off) in enumerate(bands):
        for k in range(lo, hi + 1):
            mel[:, :, m] += power[:, :, k] * wts[off + k - lo]
    return np.log10(np.maximum(mel, f32(1e-10)))


@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_fft_plan_matches_plain(n_mels):
    """The numpy model of the kernel's FFT plan against K14's plain version
    (the dense DFT of the TPU kernel) at the card's bounds: 4e-4 on the raw
    log10 above each sample's max - 8, 1e-4 normalized. Window 0 holds
    speech-like noise, window 1 a sine; both end in silence, whose frames
    sit at the 1e-10 floor in both."""
    audio = _batch()
    got = _k14_fft_model(audio, n_mels)
    want = tp.log10_mel_pallas_plain(torch.from_numpy(audio), n_mels).numpy()
    assert got.shape == want.shape == (2, 3000, n_mels)
    keep = want > want.max(axis=(1, 2), keepdims=True) - 8.0
    assert np.abs(got - want)[keep].max() <= 4e-4
    floor = want == -10.0                            # torch.log10(1e-10)
    assert floor.any()
    assert (got[floor] == np.log10(np.float32(1e-10))).all()
    norm = lambda z: (np.maximum(z, z.max(axis=(1, 2), keepdims=True) - 8.0)
                      + 4.0) / 4.0
    assert np.abs(norm(got) - norm(want)).max() <= 1e-4
