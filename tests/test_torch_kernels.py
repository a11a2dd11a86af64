"""K1 and K2 plain PyTorch versions against the JAX Pallas kernels run in
interpret mode, on the JAX tests' own cases.

The port's wrappers run the plain version for CPU tensors; on the card they
launch the CUDA kernels (tests/test_torch_kernels_gpu.py). Inputs are made
with numpy from a seed and cross as numpy arrays.

Tolerances: the plain versions repeat the Pallas kernels' arithmetic step
for step (same row-scale floor, half-to-even rounding, exact integer
products, bf16 k/v/p), so what is left is f32 summation order in the
LayerNorm, the scores and the softmax sum, which moves a bf16 output by at
most one step of the bf16 output (8 significand bits): a tolerance of
2^-7 relative with a 2^-9 floor near zero, for both kernels. The JAX
tests' own kernel-vs-reference bounds (2e-2 and 0.05 absolute) are
looser.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nobs_whisper_tpu.ops.encoder_attention import \
    encoder_attention_fused_qkv as jax_k1
from nobs_whisper_tpu.ops.fused_mlp import \
    encoder_mlp_int8_resident as jax_k2
from nobs_whisper_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from nobs_whisper_torch.models.whisper import params_from_jax
from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops import quant as tq

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _qt(w):
    return params_from_jax(jax.tree.map(np.asarray, w))


def _bf16_np(a):
    """numpy f32 copy of an array rounded to bf16 (what both sides see)."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _k1_case(b, h, t, d, seed):
    rng = np.random.RandomState(seed)
    x = _bf16_np(rng.randn(b, t, d).astype(np.float32) * 0.5)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    be = (0.1 * rng.randn(d)).astype(np.float32)
    mkw = lambda: jax_quantize_int8(jnp.asarray(
        rng.randn(d, d).astype(np.float32) * d ** -0.5))
    mkb = lambda: (0.1 * rng.randn(d)).astype(np.float32)
    wq, bq, wk, wv, bv = mkw(), mkb(), mkw(), mkw(), mkb()
    return x, g, be, wq, bq, wk, wv, bv


def _run_k1(case, n_real, h):
    x, g, be, wq, bq, wk, wv, bv = case
    d = x.shape[-1]
    sm = float(d // h) ** -0.5
    ref = np.asarray(jax_k1(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(be), wq,
        jnp.asarray(bq), wk, wv, jnp.asarray(bv), n_real, sm, h,
        block_q=128, interpret=True), np.float32)
    t = torch.from_numpy
    got = ea.encoder_attention_fused_qkv(
        t(x).to(torch.bfloat16), t(g), t(be), _qt(wq), t(bq), _qt(wk),
        _qt(wv), t(bv), n_real, sm, h)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), ref


@pytest.mark.parametrize("n_real", [256, 250, 119])
def test_k1_plain_matches_pallas_interpret(n_real):
    got, ref = _run_k1(_k1_case(2, 4, 256, 256, seed=10), n_real, h=4)
    assert np.isfinite(got).all()          # padded query rows too
    np.testing.assert_allclose(got[:, :n_real], ref[:, :n_real],
                               **BF16_STEP)


def test_k1_plain_many_pairs():
    """Three head pairs: the TPU kernel reuses its LN+quant scratch across
    pair steps; the port computes it once per call."""
    got, ref = _run_k1(_k1_case(1, 6, 128, 384, seed=11), 128, h=6)
    np.testing.assert_allclose(got, ref, **BF16_STEP)


def _k2_case(m, d, f, seed=2):
    rng = np.random.RandomState(seed)
    x = _bf16_np(rng.randn(m, d).astype(np.float32) * 0.5)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    be = (0.1 * rng.randn(d)).astype(np.float32)
    fc1 = jax_quantize_int8(jnp.asarray(
        rng.randn(d, f).astype(np.float32) * (d ** -0.5)))
    b1 = (0.1 * rng.randn(f)).astype(np.float32)
    fc2 = jax_quantize_int8(jnp.asarray(
        rng.randn(f, d).astype(np.float32) * (f ** -0.5)))
    b2 = (0.1 * rng.randn(d)).astype(np.float32)
    return x, g, be, fc1, b1, fc2, b2


@pytest.mark.parametrize("block_f", [128, 256, 2560])
def test_k2_plain_matches_pallas_interpret(block_f):
    """block_f=128 on ffn=512: four per-(row, chunk) requant chunks;
    2560 snaps to the whole ffn as the reference resolves it."""
    x, g, be, fc1, b1, fc2, b2 = _k2_case(300, 256, 512)
    ref = np.asarray(jax_k2(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(be), fc1,
        jnp.asarray(b1), fc2, jnp.asarray(b2), block_m=128,
        block_f=block_f, interpret=True), np.float32)
    t = torch.from_numpy
    got = fm.encoder_mlp_int8_resident(
        t(x).to(torch.bfloat16), t(g), t(be), _qt(fc1), t(b1), _qt(fc2),
        t(b2), block_f=block_f)
    assert got.dtype == torch.bfloat16 and got.shape == (300, 256)
    np.testing.assert_allclose(got.float().numpy(), ref, **BF16_STEP)


@pytest.mark.parametrize("block_f,ffn,want", [
    (2560, 5120, 2560), (2560, 512, 512), (640, 512, 512), (128, 512, 128),
    (384, 512, 256), (300, 512, 512),
])
def test_resolve_block_f_matches_reference(block_f, ffn, want):
    assert fm.resolve_block_f(block_f, ffn) == want


def test_cpu_wrappers_run_plain_and_count_nothing():
    """On a CPU tensor each wrapper runs its plain version; launch counters
    count kernel launches only."""
    x, g, be, wq, bq, wk, wv, bv = _k1_case(1, 2, 128, 128, seed=3)
    t = torch.from_numpy
    args = (t(x).to(torch.bfloat16), t(g), t(be), _qt(wq), t(bq), _qt(wk),
            _qt(wv), t(bv), 100, 0.125, 2)
    k1, k2 = ea.launch_count, fm.launch_count
    a = ea.encoder_attention_fused_qkv(*args)
    torch.testing.assert_close(
        a, ea.encoder_attention_fused_qkv_plain(*args), rtol=0, atol=0)
    xm, g2, be2, fc1, b1, fc2, b2 = _k2_case(64, 128, 512)
    margs = (t(xm).to(torch.bfloat16), t(g2), t(be2), _qt(fc1), t(b1),
             _qt(fc2), t(b2))
    y = fm.encoder_mlp_int8_resident(*margs, block_f=256)
    torch.testing.assert_close(
        y, fm.encoder_mlp_int8_resident_plain(*margs, block_f=256),
        rtol=0, atol=0)
    assert (ea.launch_count, fm.launch_count) == (k1, k2)


def test_int8_products_are_exact():
    """Sums of 5120 products of +-127 pass 2^24: both exact paths agree
    with an int64 oracle before their one round to f32."""
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, (20, 5120)).astype(np.int8)
    b = rng.randint(-127, 128, (5120, 24)).astype(np.int8)
    want = (a.astype(np.int64) @ b.astype(np.int64)).astype(np.float32)
    for rows in (20, 4):        # _int_mm path, then the float64 path
        got = tq.int8_matmul_exact(torch.from_numpy(a[:rows]),
                                   torch.from_numpy(b)).numpy()
        np.testing.assert_array_equal(got, want[:rows])


def test_quantize_rows_floor_and_rounding():
    """Kernel row scale: max(absmax, 1e-6)/127, half-to-even rounding."""
    h = torch.tensor([[0.0, 0.0], [127.0, 0.5], [-2.5, 1.5]])
    q, s = tq.quantize_rows(h)
    assert s[0, 0].item() == pytest.approx(1e-6 / 127)
    assert q[1].tolist() == [127, 0]          # 0.5 rounds to even 0
    assert q[2].tolist() == [-127, 76]        # 1.5/2.5*127 = 76.2


def test_quantize_int8_matches_reference():
    rng = np.random.RandomState(5)
    w = rng.randn(3, 64, 48).astype(np.float32)
    w[1, :, 3] = 0.0                           # zero column: scale 1
    ref = jax_quantize_int8(jnp.asarray(w))
    got = tq.quantize_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(ref["s"]))


def test_dense_int8_dynamic_matches_reference():
    from nobs_whisper_tpu.ops.quant import dense_int8_dynamic as jax_dense
    rng = np.random.RandomState(6)
    x = rng.randn(4, 40, 64).astype(np.float32)
    w = jax_quantize_int8(jnp.asarray(rng.randn(64, 32).astype(np.float32)))
    b = rng.randn(32).astype(np.float32)
    ref = np.asarray(jax_dense(jnp.asarray(x), w, jnp.asarray(b)))
    got = tq.dense_int8_dynamic(torch.from_numpy(x), _qt(w),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
