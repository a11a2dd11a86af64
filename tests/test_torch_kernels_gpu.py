"""Hand-written CUDA kernels K1 and K2 against their plain PyTorch versions,
on the card.

Marked ``gpu``; each test asks a fixture whether there is a card and skips
without one (the CPU suite runs the plain versions in the other
``test_torch_*`` files). This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch; from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Kernel and plain version share every rounding step on paper; what
differs is the f32 summation order (LayerNorm sums, scores, the softmax
sum), which can flip a bf16 output or an int8 activation by one step. K1
is held to one bf16 step elementwise (rtol 2^-7, atol 2^-9, as
tests/test_torch_kernels.py holds its plain version to the Pallas
kernel); K2, whose flipped int8 activation moves a whole row of fc2, to
the JAX package's own bound of 0.05 (tests/test_fused_mlp.py:78).
"""

import numpy as np
import pytest
import torch

from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops.quant import quantize_int8

pytestmark = pytest.mark.gpu

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K2_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _k1_inputs(b, h, t, d, dev, seed=10):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, t, d).astype(np.float32) * 0.5)
    g = torch.from_numpy(1.0 + 0.1 * rng.randn(d).astype(np.float32))
    be = torch.from_numpy(0.1 * rng.randn(d).astype(np.float32))
    mkw = lambda: quantize_int8(torch.from_numpy(
        rng.randn(d, d).astype(np.float32) * d ** -0.5))
    mkb = lambda: torch.from_numpy(0.1 * rng.randn(d).astype(np.float32))
    wq, bq, wk, wv, bv = mkw(), mkb(), mkw(), mkw(), mkb()
    to = lambda z: ({k: v.to(dev) for k, v in z.items()}
                    if isinstance(z, dict) else z.to(dev))
    return (x.to(dev, torch.bfloat16), *(to(z) for z in
                                         (g, be, wq, bq, wk, wv, bv)))


def _k2_inputs(m, d, f, dev, seed=2):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, d).astype(np.float32) * 0.5)
    g = torch.from_numpy(1.0 + 0.1 * rng.randn(d).astype(np.float32))
    be = torch.from_numpy(0.1 * rng.randn(d).astype(np.float32))
    fc1 = quantize_int8(torch.from_numpy(
        rng.randn(d, f).astype(np.float32) * d ** -0.5))
    b1 = torch.from_numpy(0.1 * rng.randn(f).astype(np.float32))
    fc2 = quantize_int8(torch.from_numpy(
        rng.randn(f, d).astype(np.float32) * f ** -0.5))
    b2 = torch.from_numpy(0.1 * rng.randn(d).astype(np.float32))
    to = lambda z: ({k: v.to(dev) for k, v in z.items()}
                    if isinstance(z, dict) else z.to(dev))
    return (x.to(dev, torch.bfloat16), *(to(z) for z in
                                         (g, be, fc1, b1, fc2, b2)))


@pytest.mark.parametrize("b,h,t,d,n_real", [
    (2, 4, 256, 256, 256), (2, 4, 256, 256, 250), (2, 4, 256, 256, 119),
    (1, 6, 128, 384, 128),                  # many head pairs
    (2, 20, 1536, 1280, 1500),              # large-v3-turbo width
])
def test_k1_kernel_matches_plain(cuda, b, h, t, d, n_real):
    args = _k1_inputs(b, h, t, d, cuda)
    sm = float(d // h) ** -0.5
    before = ea.launch_count
    got = ea.encoder_attention_fused_qkv(*args, n_real, sm, h)
    torch.cuda.synchronize()
    assert ea.launch_count == before + 1
    ref = ea.encoder_attention_fused_qkv_plain(*args, n_real, sm, h)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()     # padded rows included
    np.testing.assert_allclose(got.float()[:, :n_real].cpu().numpy(),
                               ref.float()[:, :n_real].cpu().numpy(),
                               **BF16_STEP)


@pytest.mark.parametrize("m,d,f,block_f", [
    (300, 256, 512, 128),                   # ragged m, 4 requant chunks
    (512, 256, 512, 512),
    (2 * 1536, 1280, 5120, 2560),           # large-v3-turbo width
])
def test_k2_kernel_matches_plain(cuda, m, d, f, block_f):
    args = _k2_inputs(m, d, f, cuda)
    before = fm.launch_count
    got = fm.encoder_mlp_int8_resident(*args, block_f=block_f)
    torch.cuda.synchronize()
    assert fm.launch_count == before + 1
    ref = fm.encoder_mlp_int8_resident_plain(*args, block_f=block_f)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs().max().item()
    assert err < K2_TOL, err


def test_wrappers_refuse_f32_on_card(cuda):
    """On a CUDA tensor a wrapper launches its kernel or raises: no quiet
    fallback to the plain version."""
    args = _k1_inputs(1, 2, 128, 128, cuda)
    with pytest.raises(ValueError):
        ea.encoder_attention_fused_qkv(args[0].float(), *args[1:], 128,
                                       0.125, 2)
    args = _k2_inputs(128, 128, 512, cuda)
    with pytest.raises(ValueError):
        fm.encoder_mlp_int8_resident(args[0].float(), *args[1:])


def test_int8_encoder_on_card_goes_through_both_kernels(cuda):
    """The int8 encoder at a dh=64 width on the card: every layer launches
    K1 and K2 once, and the states agree with the same bf16 encoder run on
    the CPU (plain versions). Tolerance 5e-2: the two runs share every
    rounding rule, but a bf16 step (2^-8 relative) in one layer's output
    moves the next layer's int8 activations, over 2 layers and ln_post."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    params = quantize_encoder_params(
        tw.init_params(3, cfg, dtype=torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(2, 80, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(cuda))
    k1, k2 = ea.launch_count, fm.launch_count
    got = tw.encode(to_dev(params), mel.to(cuda), cfg,
                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (ea.launch_count - k1, fm.launch_count - k2) == \
        (cfg.n_audio_layer, cfg.n_audio_layer)
    ref = tw.encode(params, mel, cfg, compute_dtype=torch.bfloat16)
    assert torch.isfinite(got.float()).all()
    err = (got.float().cpu() - ref.float()).abs().max().item()
    assert err < 5e-2, err


def test_int8_encoder_at_f32_raises_on_card(cuda):
    """The kernels take bf16 activations: an int8 encoder at f32 compute
    on the card raises and launches nothing, where the CPU runs the
    kernels' plain versions at f32 as the reference does."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    params = quantize_encoder_params(tw.init_params(3, cfg, device=cuda))
    k1, k2 = ea.launch_count, fm.launch_count
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tw.encode(params, torch.zeros(1, 80, 64, device=cuda), cfg)
    assert (ea.launch_count, fm.launch_count) == (k1, k2)
