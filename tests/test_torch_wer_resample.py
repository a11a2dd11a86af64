"""The port's copies of the JAX package's offline helpers, on the CPU:
``utils/wer.py`` (copied as is) gives the reference's results on the cases
of ``tests/test_wer.py``, and ``audio/resample.py::resample_torch`` is
within 1e-6 of ``resample_jax`` on the reference's rates, with the same
length."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_WER_CASES = [("the cat sat", "The cat sat."), ("a b c d", "a x c"),
              ("a b", "a x b y"), ("", ""), ("a b", ""),
              ("don't stop", "don’t stop"),
              ("I can't  do it.", "i cannot do it"), ("café", "cafe")]


@pytest.mark.parametrize("ref,hyp", _WER_CASES)
def test_word_error_rate_matches_reference(ref, hyp):
    from nobs_whisper_tpu.utils import wer as jw
    from nobs_whisper_torch.utils import wer as tw
    assert dataclasses.asdict(tw.word_error_rate(ref, hyp)) == \
        dataclasses.asdict(jw.word_error_rate(ref, hyp))
    assert tw.normalize_text(hyp) == jw.normalize_text(hyp)


def test_wer_cases_of_the_reference_suite():
    """``tests/test_wer.py``'s assertions, on the port's copy."""
    from nobs_whisper_torch.utils.wer import (corpus_wer, normalize_text,
                                              word_error_rate)
    assert normalize_text("Hello, World!") == "hello world"
    assert normalize_text("I can't  do it.") == "i cannot do it"
    assert normalize_text("café") == "cafe"
    assert normalize_text("it's fine") == "its fine"
    r = word_error_rate("the cat sat", "The cat sat.")
    assert r.wer == 0.0 and r.exact_match
    r = word_error_rate("a b c d", "a x c")
    assert (r.substitutions, r.deletions, r.insertions) == (1, 1, 0)
    assert r.wer == pytest.approx(0.5)
    r = word_error_rate("a b", "a x b y")
    assert r.insertions == 2 and r.wer == pytest.approx(1.0)
    assert word_error_rate("", "").wer == 0.0
    assert word_error_rate("a b", "").wer == pytest.approx(1.0)
    agg = corpus_wer([("a b c", "a b c"), ("x y", "x z")])
    assert agg.ref_words == 5 and agg.wer == pytest.approx(0.2)
    assert not agg.exact_match
    assert word_error_rate("don't stop", "don’t stop").wer == 0.0


def test_corpus_wer_matches_reference():
    from nobs_whisper_tpu.utils.wer import corpus_wer as jc
    from nobs_whisper_torch.utils.wer import corpus_wer as tc
    pairs = [("a b c", "a b c"), ("x y", "x z"), ("one two three", "one")]
    assert dataclasses.asdict(tc(pairs)) == dataclasses.asdict(jc(pairs))


@pytest.mark.parametrize("rate,n", [(48000, 48000), (44100, 44100),
                                    (16000, 16000), (48000, 1237),
                                    (44100, 977)])
def test_resample_torch_matches_resample_jax(rate, n):
    """Same length (floor(n*up/down), the identity at 16 kHz) and within
    1e-6 of the JAX twin: both sum the same 24 f32 products an output
    sample, in the orders of their own reductions."""
    from nobs_whisper_tpu.audio.resample import resample_jax
    from nobs_whisper_torch.audio.resample import resample_torch
    rng = np.random.RandomState(rate % 97 + n)
    t = np.arange(n) / rate
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)
             + 0.05 * rng.randn(n)).astype(np.float32)
    want = np.asarray(resample_jax(jnp.asarray(audio), rate))
    got = resample_torch(torch.from_numpy(audio), rate)
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    if rate == 16000:
        assert torch.equal(got, torch.from_numpy(audio))


def test_resample_torch_stays_on_its_device():
    """The resample runs where its input lies (the CPU here; a card's
    tensor stays on the card) and takes numpy input too."""
    from nobs_whisper_torch.audio.resample import resample_torch
    x = np.zeros(4800, np.float32)
    out = resample_torch(x, 48000)
    assert out.device.type == "cpu" and out.shape == (1600,)
