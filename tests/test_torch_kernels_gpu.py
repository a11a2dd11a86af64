"""Hand-written CUDA kernels K1, K2 (bf16 and f32 activations), K3 and K9
against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks a fixture whether there is a card and skips
without one (the CPU suite runs the plain versions in the other
``test_torch_*`` files). This file imports neither JAX nor the JAX package,
so it runs on a machine that has only PyTorch; from the repo root:

    python -m pytest -p no:cacheprovider --noconftest -m gpu \
        tests/test_torch_kernels_gpu.py

Kernel and plain version share every rounding step on paper; what
differs is the f32 summation order (LayerNorm sums, scores, the softmax
sum), which can flip a bf16 output or an int8 activation by one step. K1,
K3 and K9 are held to one bf16 step elementwise (rtol 2^-7, atol 2^-9, as
tests/test_torch_kernels.py holds their plain versions to the Pallas
kernels); K2, whose flipped int8 activation moves a whole row of fc2, to
the JAX package's own bound of 0.05 (tests/test_fused_mlp.py:78), at both
activation types.
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
    fallback to the plain version. The attention kernels take bf16 only
    (the reference runs them at bf16 compute only); K2 takes f32 too."""
    args = _k1_inputs(1, 2, 128, 128, cuda)
    with pytest.raises(ValueError):
        ea.encoder_attention_fused_qkv(args[0].float(), *args[1:], 128,
                                       0.125, 2)
    q = torch.zeros(1, 128, 128, device=cuda)
    with pytest.raises(ValueError):
        ea.encoder_attention_btd(q, q, q, 128, 0.125, 2)
    with pytest.raises(ValueError):
        ea.encoder_attention(q[None], q[None], q[None], 128, 0.125)
    h = torch.zeros(1, 2, 128, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ea.encoder_attention(h, h, h, 128, 0.25)      # dh = 16: not built
    args = _k2_inputs(128, 128, 512, cuda)
    before = fm.launch_count_f32
    y = fm.encoder_mlp_int8_resident(args[0].float(), *args[1:])
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and fm.launch_count_f32 == before + 1


def _attn_inputs(shape, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(*shape, generator=g, device=dev) * 0.5).to(
        torch.bfloat16) for _ in range(3)]


def _step_close(got, ref):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **BF16_STEP)


@pytest.mark.parametrize("b,t,h,dh,n_real", [
    (2, 256, 4, 64, 256), (2, 256, 4, 64, 250), (2, 256, 4, 64, 40),
    (1, 768, 20, 64, 750),                  # audio_ctx 750
    (2, 1536, 20, 64, 1500),                # large-v3-turbo width
])
def test_k3_kernel_matches_plain(cuda, b, t, h, dh, n_real):
    q, k, v = _attn_inputs((b, t, h * dh), cuda, seed=t + n_real)
    sm = float(dh) ** -0.5
    before = ea.k3_launch_count
    got = ea.encoder_attention_btd(q, k, v, n_real, sm, h)
    torch.cuda.synchronize()
    assert ea.k3_launch_count == before + 1
    ref = ea.encoder_attention_btd_plain(q, k, v, n_real, sm, h)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()     # padded rows included
    _step_close(got[:, :n_real], ref[:, :n_real])


@pytest.mark.parametrize("b,h,t,dh,n_real", [
    (2, 3, 256, 64, 250), (1, 3, 256, 64, 40),     # odd heads
    (2, 4, 256, 32, 256), (2, 4, 512, 128, 300),   # other head widths
    (2, 10, 1536, 128, 1500),                      # turbo width, dh = 128
])
def test_k9_kernel_matches_plain(cuda, b, h, t, dh, n_real):
    q, k, v = _attn_inputs((b, h, t, dh), cuda, seed=dh + n_real)
    sm = float(dh) ** -0.5
    before = ea.k9_launch_count
    got = ea.encoder_attention(q, k, v, n_real, sm)
    torch.cuda.synchronize()
    assert ea.k9_launch_count == before + 1
    ref = ea.encoder_attention_plain(q, k, v, n_real, sm)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    _step_close(got[..., :n_real, :], ref[..., :n_real, :])


@pytest.mark.parametrize("m,d,f,block_f", [
    (300, 256, 512, 128), (2 * 1536, 1280, 5120, 2560)])
def test_k2_f32_kernel_matches_plain(cuda, m, d, f, block_f):
    args = _k2_inputs(m, d, f, cuda, seed=5)
    x = args[0].float() + 1e-3 * torch.randn(m, d, device=cuda)
    before = fm.launch_count_f32
    got = fm.encoder_mlp_int8_resident(x, *args[1:], block_f=block_f)
    torch.cuda.synchronize()
    assert fm.launch_count_f32 == before + 1
    ref = fm.encoder_mlp_int8_resident_plain(x, *args[1:], block_f=block_f)
    assert got.dtype == torch.float32
    err = (got - ref).abs().max().item()
    assert err < K2_TOL, err


@pytest.mark.parametrize("d,heads,kernel", [(128, 2, "K3"), (192, 3, "K9")])
def test_float_encoder_on_card_launches_attention_kernel(cuda, d, heads,
                                                         kernel):
    """An unquantized bf16 encoder on the card: K3 (heads pair) or K9 (odd
    head count) once per layer, states within 5e-2 of the same encoder on
    the CPU (plain versions), as the int8 encoder test below."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=d, heads=heads, n_audio_ctx=32)
    params = tw.init_params(3, cfg, dtype=torch.bfloat16)
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(2, 80, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(cuda))
    counts = lambda: {"K1": ea.launch_count, "K3": ea.k3_launch_count,
                      "K9": ea.k9_launch_count}
    before = counts()
    got = tw.encode(to_dev(params), mel.to(cuda), cfg,
                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    after = counts()
    want = {"K1": 0, "K3": 0, "K9": 0, kernel: cfg.n_audio_layer}
    assert {k: after[k] - before[k] for k in after} == want
    ref = tw.encode(params, mel, cfg, compute_dtype=torch.bfloat16)
    assert torch.isfinite(got.float()).all()
    err = (got.float().cpu() - ref.float()).abs().max().item()
    assert err < 5e-2, err


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


def test_int8_encoder_at_f32_serves_on_card(cuda):
    """An int8 encoder at f32 compute on the card runs the reference's TPU
    gate: K2's f32 variant once per layer, no attention kernel (torch ops
    at f32), states within 5e-2 of the same encoder on the CPU."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    params = quantize_encoder_params(tw.init_params(3, cfg))
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(1, 80, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(cuda))
    k1, k2, k2f = ea.launch_count, fm.launch_count, fm.launch_count_f32
    got = tw.encode(to_dev(params), mel.to(cuda), cfg)
    torch.cuda.synchronize()
    assert (ea.launch_count - k1, fm.launch_count - k2,
            fm.launch_count_f32 - k2f) == (0, cfg.n_audio_layer,
                                           cfg.n_audio_layer)
    ref = tw.encode(params, mel, cfg)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = (got.cpu() - ref).abs().max().item()
    assert err < 5e-2, err
