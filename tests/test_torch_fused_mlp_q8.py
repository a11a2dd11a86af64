"""K7 (``ops/fused_mlp.py::fused_mlp_q8``, the decoder MLP for a few rows
on int8 weights dequantized to bf16) on the CPU, against the JAX package.

The port's plain version (what the wrapper runs on a CPU tensor) is held
to ``_fused_mlp_kernel`` in interpret mode, and the port's op to the
port's ``mlp_reference`` as ``tests/test_fused_mlp.py`` holds the Pallas
kernel to the reference's. Both sides get the same int8 ``q`` and ``s``:
the weights are quantized once with the JAX ``quantize_int8`` and the
arrays cross as numpy; the port does not re-quantize. The kernel itself
runs on the card (tests/test_torch_kernels_gpu.py).

Tolerances, each with its reason:

* Plain against interpret mode: the products are exact in f32 (bf16 x
  bf16) and only the f32 summation order differs. bf16 x: one bf16 step
  (rtol 2^-7, atol 2^-9); f32 x: 1e-5 absolute plus 1e-5 relative on
  outputs of order 1 (readings: bf16 equal, f32 at most 2.5e-6).
* Rows: M = 8 and M = 16, never M = 1. At M = 1 XLA:CPU fuses the
  kernel's bf16 weight product into its matrix-vector product and skips
  that rounding (ROADMAP.md section 3, the K6 limit): the interpret-mode
  output at M = 1 is not the TPU kernel's function (measured: 41% of bf16
  outputs and every f32 output differ from the plain version, by up to
  one bf16 step). M = 2 and M = 4 do not meet the limit (equal in bf16,
  within 5e-7 in f32), so M = 4, ``test_fused_mlp_bf16_io``'s size, is
  held too.
* Against ``mlp_reference`` (exact erf gelu): the reference test's 2e-2
  (f32 x) and 0.1 (bf16 x) bounds (``tests/test_fused_mlp.py:12-44``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nobs_whisper_tpu.ops import fused_mlp as jf
from nobs_whisper_tpu.ops.quant import quantize_int8
from nobs_whisper_torch.ops import fused_mlp as tf

TOL = {"bf16": dict(rtol=2.0 ** -7, atol=2.0 ** -9),
       "f32": dict(rtol=1e-5, atol=1e-5)}
DT = {"bf16": (jnp.bfloat16, torch.bfloat16),
      "f32": (jnp.float32, torch.float32)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(m, d, ffn, seed):
    """x, a LayerNorm that is not the identity, int8 weights quantized
    once by the reference, non-zero biases; numpy arrays."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, d) * 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    fc1 = {k: np.array(v) for k, v in quantize_int8(jnp.asarray(
        rng.randn(d, ffn).astype(np.float32) * 0.05)).items()}
    fc2 = {k: np.array(v) for k, v in quantize_int8(jnp.asarray(
        rng.randn(ffn, d).astype(np.float32) * 0.05)).items()}
    b1 = (0.05 * rng.randn(ffn)).astype(np.float32)
    b2 = (0.05 * rng.randn(d)).astype(np.float32)
    return x, g, b, fc1, b1, fc2, b2


def _jax(args, jdt):
    x, g, b, fc1, b1, fc2, b2 = args
    qt = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    return (jnp.asarray(x).astype(jdt), jnp.asarray(g), jnp.asarray(b),
            qt(fc1), jnp.asarray(b1), qt(fc2), jnp.asarray(b2))


def _torch(args, jdt, tdt):
    x, g, b, fc1, b1, fc2, b2 = args
    qt = lambda t: {k: torch.from_numpy(v) for k, v in t.items()}
    xr = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    return (torch.from_numpy(xr).to(tdt), torch.from_numpy(g),
            torch.from_numpy(b), qt(fc1), torch.from_numpy(b1), qt(fc2),
            torch.from_numpy(b2))


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("m", [4, 8, 16])
def test_k7_plain_matches_pallas_interpret(m, x_dtype):
    jdt, tdt = DT[x_dtype]
    args = _case(m, 128, 512, seed=m)
    want = jf.fused_mlp_q8(*_jax(args, jdt), interpret=True)
    got = tf.fused_mlp_q8(*_torch(args, jdt, tdt))
    assert got.dtype == tdt and tuple(got.shape) == (m, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[x_dtype])


def test_k7_matches_mlp_reference():
    """``tests/test_fused_mlp.py::test_fused_mlp_matches_reference`` on the
    port: f32 x, trivial LayerNorm, 2e-2; the port's ``mlp_reference``
    also equals the reference's to 1e-5."""
    rng = np.random.RandomState(0)
    d, ffn, m = 128, 512, 8
    x = rng.randn(m, d).astype(np.float32) * 0.5
    fc1 = {k: np.array(v) for k, v in quantize_int8(jnp.asarray(
        rng.randn(d, ffn).astype(np.float32) * 0.05)).items()}
    b1 = rng.randn(ffn).astype(np.float32) * 0.01
    fc2 = {k: np.array(v) for k, v in quantize_int8(jnp.asarray(
        rng.randn(ffn, d).astype(np.float32) * 0.05)).items()}
    b2 = rng.randn(d).astype(np.float32) * 0.01
    args = (x, np.ones(d, np.float32), np.zeros(d, np.float32), fc1, b1,
            fc2, b2)
    targs = _torch(args, jnp.float32, torch.float32)
    ref = tf.mlp_reference(*targs).numpy()
    got = tf.fused_mlp_q8(*targs).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    jref = np.asarray(jf.mlp_reference(*_jax(args, jnp.float32)))
    np.testing.assert_allclose(ref, jref, rtol=1e-5, atol=1e-5)


def test_k7_bf16_io_matches_mlp_reference():
    """``test_fused_mlp_bf16_io`` on the port: bf16 x in and out, within
    0.1 of ``mlp_reference``."""
    rng = np.random.RandomState(1)
    d, ffn, m = 128, 256, 4
    x = torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(
        torch.bfloat16)
    fc1 = {k: torch.from_numpy(np.array(v)) for k, v in quantize_int8(
        jnp.asarray(rng.randn(d, ffn).astype(np.float32) * 0.05)).items()}
    fc2 = {k: torch.from_numpy(np.array(v)) for k, v in quantize_int8(
        jnp.asarray(rng.randn(ffn, d).astype(np.float32) * 0.05)).items()}
    args = (x, torch.ones(d), torch.zeros(d), fc1, torch.zeros(ffn), fc2,
            torch.zeros(d))
    out = tf.fused_mlp_q8(*args)
    assert out.dtype == torch.bfloat16
    ref = tf.mlp_reference(*args)
    assert (out.float() - ref.float()).abs().max() < 0.1


def test_k7_not_on_decode_paths(monkeypatch, tmp_path):
    """Nothing in the decoder calls K7, in either package: the window
    program (through the batcher) and ``transcribe`` on an int8 engine
    call neither its wrapper nor its plain version, and its launch
    counter stays 0. A direct call is counted (the spy works)."""
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import (KernelSpies,
                                                  speech_like_audio,
                                                  write_tiny_checkpoint)
    path = str(tmp_path / "m.bin")
    write_tiny_checkpoint(path)
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    eng = eng.quantize()
    spies = KernelSpies(monkeypatch.setattr, kernels=("K7",))
    wrapper_calls = []
    real = tf.fused_mlp_q8
    monkeypatch.setattr(tf, "fused_mlp_q8",
                        lambda *a, **k: wrapper_calls.append(1) or real(*a,
                                                                        **k))
    audio = speech_like_audio(1.5, seed=5)
    assert eng.transcribe(audio, language="en").segments is not None
    be = BatchedEngine(eng, max_batch=2)
    try:
        assert be.transcribe(audio, language="en").segments is not None
    finally:
        be.close()
    assert spies.calls["K7"] == 0 and not wrapper_calls
    assert tf.k7_launch_count == 0
    tf.fused_mlp_q8(*_torch(_case(2, 128, 256, seed=0), jnp.float32,
                            torch.float32))
    assert spies.calls["K7"] == 1
