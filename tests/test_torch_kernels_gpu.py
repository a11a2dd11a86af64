"""Hand-written CUDA kernels K1, K2 (bf16 and f32 activations), K3, K9,
the decode-step kernels K4, K5 and K6, the encoder knobs' K8, K10,
K11 (bf16 and f32 activations) and K13, the last encoder variants (K1
with the o projection fused, K12, the int8 scores and PV of K1, K3 and
K12; tolerances at :data:`VAR_TOL`), and the two ops K14 (log-mel) and K7
(the decoder MLP for a few rows) against their plain PyTorch versions, on
the card.

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
activation types; K2 and K8 are besides held bit for bit to the port's
first, mma.sync version of their kernels (tests/goldens/
fused_mlp_mma_sync.cu, built here): their int32 sums are exact and the
absmax is order-free, so every order of the sums gives the same bits.
K4 and K5 (f32 output of bf16 probabilities times V) are held to one bf16
step elementwise, as their plain versions are held to the Pallas kernels
(tests/test_torch_decode_kernels.py); K5 also where its cluster's slices
are short, empty or wholly masked, and two calls give the same bits. K4
kept its first kernel and K6 its kernels when K5 and K7 were redesigned:
both are held bit for bit to those files (tests/goldens/
xattn_decode_v1.cu, q8_matmul_v1.cu, with the common.cuh they were built
with, tests/goldens/common_v1.cuh). K6 rounds the same
bf16 operands as its plain version and differs in the order, and in the
tensor cores the rounding, of its f32 sums: 1e-3 absolute plus 1e-3
relative on outputs of order 1. K8, K10 and K11 share K2's int8
numerics and its bound of 0.05 (tests/test_fused_qkv.py:37,51); K10 and
K11 are besides held bit for bit to the port's first kernels
(tests/goldens/fused_qkv_mma_sync.cu with the common.cuh it was built
with, tests/goldens/common_mma_sync.cuh, so the quantization pass too),
for the same reason as K2; so are K1's and K12's projections at every
flag (tests/goldens/k1_proj_mma_sync.cu, the port's first, mma.sync
q/k/v and o GEMMs). K13 rounds
the same bf16 operands at the same points in another summation order; a
flipped bf16 sum before a flat stretch of the gelu is several output
steps: the JAX tests' 3e-2 (tests/test_conv_stem.py:34-36), padded rows
exact zeros. K14 is a real FFT in f32 on FFMA where its plain version
does dense f32 DFT matmuls (TF32 off): the normalized output is held to
1e-4, the bound tests/test_mel_pallas.py holds the Pallas kernel to, and
the un-normalized log10 to the same bound in its units (4e-4) where it
lies above each sample's max - 8 (below it the log10 of near-zero bins
depends on the rounding); on windows where the dense DFT's own rounding
is past those bounds, against the f64 oracle. K7 rounds the same bf16 operands at the
same points in another f32 summation order, which can flip a bf16 element
of the gelu output by one step: bf16 x to one bf16 step elementwise, f32 x
to 1e-3 absolute plus 1e-3 relative, as K6; two
calls give the same bits, with fc2 by programmatic dependent launch or
not.
"""

import numpy as np
import pytest
import torch

from nobs_whisper_torch.audio.mel import log_mel_numpy_f64, log_mel_spectrogram
from nobs_whisper_torch.ops import attention_pallas as ap
from nobs_whisper_torch.ops import conv_stem as cs
from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_layer as fl
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops import fused_qkv as fq
from nobs_whisper_torch.ops import mel_pallas as mp
from nobs_whisper_torch.ops import quant as qt
from nobs_whisper_torch.ops.quant import quantize_int8
from nobs_whisper_torch.utils.testing import tone_burst_windows

pytestmark = pytest.mark.gpu

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K2_TOL = 5e-2
K6_TOL = dict(rtol=1e-3, atol=1e-3)


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
    (2, 4, 192, 256, 150),                  # T % 128 == 64
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
    # the wgmma kernel's edges: T % 128 == 64 (the last block's second
    # warpgroup has no rows), n_real inside the first key tile and one key
    # past a tile, the other head widths
    (2, 192, 4, 64, 192), (1, 832, 20, 64, 800),
    (2, 192, 4, 64, 40), (1, 320, 4, 64, 65),
    (2, 192, 2, 128, 129), (1, 320, 6, 32, 257),
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
    (2, 20, 1536, 64, 1500),                       # turbo, NWT_INT8_QKV
    # T % 128 == 64 with odd head counts at each head width, n_real in the
    # first key tile and one key past a tile
    (1, 3, 192, 128, 150), (1, 5, 320, 32, 257), (2, 3, 192, 64, 70),
    (1, 3, 832, 64, 800), (2, 5, 192, 64, 1), (1, 3, 320, 128, 65),
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


def _cross_kv(b, h, t, dh, dev, seed):
    """q (B, H, 1, Dh) bf16 and one layer of cross-KV (1, B, H, T, Dh)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    k = torch.randn(1, b, h, t, dh, generator=g, device=dev)
    v = torch.randn(1, b, h, t, dh, generator=g, device=dev)
    return q, k, v


DECODE_CASES = [
    (2, 4, 300, 300, 64), (2, 4, 300, 40, 64),      # t_real in one tile
    (1, 20, 1500, 1500, 64), (8, 20, 1500, 1500, 64),  # turbo, B = 1 and 8
    (1, 20, 750, 750, 64),                           # audio_ctx 750
    (2, 10, 300, 250, 128), (2, 4, 300, 300, 32),    # other head widths
]


@pytest.mark.parametrize("b,h,t,t_real,dh", DECODE_CASES)
def test_k4_kernel_matches_plain(cuda, b, h, t, t_real, dh):
    q, k, v = _cross_kv(b, h, t, dh, cuda, seed=t + dh)
    kd, vd = ap.pack_cross_kv_bf16((k, v))
    packed = {"kT": kd["kT"][0], "v": vd["v"][0]}
    before = ap.k4_launch_count
    got = ap.cross_attention_decode_bf16(q, packed, t_real)
    torch.cuda.synchronize()
    assert ap.k4_launch_count == before + 1
    ref = ap.cross_attention_decode_bf16_plain(q, packed, t_real)
    assert got.shape == ref.shape == (b, h, 1, dh)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _step_close(got, ref)


@pytest.fixture(scope="module")
def xattn_v1():
    """The port's first K4 and K5 (``tests/goldens/xattn_decode_v1.cu``:
    one block per (batch row, head)), built on the card: the bits K4 must
    still give."""
    return _golden("xattn_decode_v1.cu", "goldens_xattn", ap._SIG,
                   "common_v1.cuh")


@pytest.mark.parametrize("b,h,t,t_real,dh", DECODE_CASES)
def test_k4_bits_match_its_first_kernel(cuda, xattn_v1, b, h, t, t_real, dh):
    """K4 kept its kernel when K5 got a cluster of its own: the same bits
    as the first version at every geometry."""
    q, k, v = _cross_kv(b, h, t, dh, cuda, seed=t + dh)
    kd, vd = ap.pack_cross_kv_bf16((k, v))
    kT, vv = kd["kT"][0].contiguous(), vd["v"][0].contiguous()
    got = ap.cross_attention_decode_bf16(q, {"kT": kT, "v": vv}, t_real)
    want = torch.empty_like(got)
    qb = q.contiguous()
    err = xattn_v1.nwt_xattn_decode_bf16(
        qb.data_ptr(), kT.data_ptr(), vv.data_ptr(), want.data_ptr(), b * h,
        dh, kT.shape[-1], t_real, ap._F(float(dh) ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# K5 beyond DECODE_CASES: turbo at B = 16 (the plan's C = 2 at 320 pairs)
K5_CASES = DECODE_CASES + [(16, 20, 1500, 1500, 64)]


@pytest.mark.parametrize("b,h,t,t_real,dh", K5_CASES)
def test_k5_kernel_matches_plain(cuda, b, h, t, t_real, dh):
    q, k, v = _cross_kv(b, h, t, dh, cuda, seed=t + dh + 1)
    kq, vq = ap.quantize_cross_kv((k[..., :t_real, :], v[..., :t_real, :]))
    kq, vq = ({z: w[0] for z, w in kq.items()},
              {z: w[0] for z, w in vq.items()})
    before = ap.k5_launch_count
    got = ap.cross_attention_decode_q8(q, kq, vq)
    torch.cuda.synchronize()
    assert ap.k5_launch_count == before + 1
    ref = ap.cross_attention_decode_q8_plain(q, kq, vq)
    assert got.shape == ref.shape == (b, h, 1, dh)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _step_close(got, ref)


def _k5_operands(b, h, tp, dh, dev, seed, masked=None):
    """q and int8 cross-KV at any Tp % 16 == 0 (not only the 128-padded
    layouts ``quantize_cross_kv`` makes): random int8 K and V, positive
    scales, zero (masked) at the positions ``masked`` selects."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(b, h, 1, dh, generator=g, device=dev) * 0.5).to(
        torch.bfloat16)
    i8 = lambda *sh: torch.randint(-127, 128, sh, generator=g, device=dev,
                                   dtype=torch.int8)
    sc = lambda: torch.rand(b, h, tp, generator=g, device=dev) * 0.05 + 1e-3
    kq = {"q": i8(b, h, dh, tp), "s": sc()}
    vq = {"q": i8(b, h, tp, dh), "s": sc()}
    if masked is not None:
        kq["s"][..., masked] = 0.0
    return q, kq, vq


# (B, H, Tp, Dh, masked positions): every position masked (a uniform p,
# the plan's C > 1); all but the first 40 (whole slices masked); 13
# 16-position chunks (Tp = 208: slices of 32, the last short, the
# cluster's last block empty) and 23 (Tp = 368, C = 16: 2 chunks a slice);
# turbo at B = 1, 8 and 16 with the last 36 positions masked
K5_EDGE_CASES = [
    (1, 20, 1536, 64, slice(None)), (2, 4, 128, 64, slice(None)),
    (1, 20, 1536, 64, slice(40, None)), (1, 4, 208, 64, None),
    (1, 4, 208, 32, slice(100, 150)), (1, 2, 368, 128, None),
    (1, 20, 1536, 64, slice(1500, None)), (8, 20, 1536, 64, slice(1500, None)),
    (16, 20, 1536, 64, slice(1500, None)),
]


@pytest.mark.parametrize("b,h,tp,dh,masked", K5_EDGE_CASES)
def test_k5_edges_match_plain(cuda, b, h, tp, dh, masked):
    """K5 within one bf16 step of its plain version where slices are
    short, empty or wholly masked, and where every position is masked
    (the plain version's p is then uniform: each block's max is -1e30)."""
    q, kq, vq = _k5_operands(b, h, tp, dh, cuda, seed=tp + dh + b, masked=masked)
    before = ap.k5_launch_count
    got = ap.cross_attention_decode_q8(q, kq, vq)
    torch.cuda.synchronize()
    assert ap.k5_launch_count == before + 1
    ref = ap.cross_attention_decode_q8_plain(q, kq, vq)
    assert got.shape == ref.shape == (b, h, 1, dh)
    assert torch.isfinite(got).all()
    _step_close(got, ref)


@pytest.mark.parametrize("b", [1, 8])
def test_k5_kernel_is_deterministic(cuda, b):
    """Two calls give the same bits (the cluster's sums are taken in rank
    order); the output comes from an allocation that held NaNs just
    before, so an element the kernel did not write would show."""
    q, kq, vq = _k5_operands(b, 20, 1536, 64, cuda, seed=b,
                             masked=slice(1500, None))
    outs = []
    for _ in range(2):
        junk = torch.full((b, 20, 1, 64), float("nan"), device=cuda)
        del junk
        outs.append(ap.cross_attention_decode_q8(q, kq, vq))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])


def _q8_weight(k, n, dev, seed, offset=0):
    """An int8 (K, N) QTensor on the card whose rows start ``offset`` bytes
    into a larger buffer (the kernel takes any byte alignment)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = quantize_int8(torch.randn(k, n, generator=g, device=dev) * k ** -0.5)
    if offset:
        buf = torch.zeros(k * n + offset, dtype=torch.int8, device=dev)
        buf[offset:] = w["q"].reshape(-1)
        w["q"] = buf[offset:].view(k, n)
    return w


# the decode kernel takes M <= 16 (8-row x tiles: M = 1, 2, 8 one, M = 16
# two), the prefill kernel 16 < M <= 256 (64-row tiles: 17, 64, 65, 256);
# the logit projection (N = 51,866: rows at every byte offset mod 16) and
# fc2 (K = 5120, N = 1280: the deepest K split), both x types
K6_ROWS = (1, 2, 8, 16, 17, 64, 65, 256)
K6_CASES = [
    (1, 320, 1000, torch.bfloat16, 0),
    (3, 64, 100, torch.float32, 0),                  # one slab, N % 4 != 0
    (8, 1280, 5120, torch.bfloat16, 0),              # fc1
    (8, 1280, 1280, torch.bfloat16, 3),              # misaligned rows
    (12, 1280, 1000, torch.float32, 5),              # both, two x tiles
    (256, 1280, 1280, torch.float32, 0),
] + [(m, k, n, x_dtype, 0) for m in K6_ROWS
     for k, n in ((1280, 51866), (5120, 1280))
     for x_dtype in (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("m,k,n,x_dtype,offset", K6_CASES)
def test_k6_kernel_matches_plain(cuda, m, k, n, x_dtype, offset):
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(x_dtype)
    w = _q8_weight(k, n, cuda, seed=k + n, offset=offset)
    before = qt.k6_launch_count
    got = qt.q8_matmul(x, w)
    torch.cuda.synchronize()
    assert qt.k6_launch_count == before + 1
    ref = qt.q8_matmul_plain(x, w)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               **K6_TOL)


@pytest.fixture(scope="module")
def q8_v1():
    """K6 as it was before its decode kernel moved into
    ``csrc/q8_decode.cuh`` (``tests/goldens/q8_matmul_v1.cu``), built on the
    card: the bits K6 must still give."""
    return _golden("q8_matmul_v1.cu", "goldens_q8", qt._Q8_SIG,
                   "common_v1.cuh")


@pytest.mark.parametrize("m,k,n,x_dtype,offset", K6_CASES)
def test_k6_bits_match_v1(cuda, q8_v1, m, k, n, x_dtype, offset):
    """K6 on the shared decode header gives the bits of its own first
    file at every case, both kernels and both x types."""
    g = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(x_dtype)
    w = _q8_weight(k, n, cuda, seed=k + n, offset=offset)
    got = qt.q8_matmul(x, w)
    want = torch.empty_like(got)
    s = w["s"].to(torch.float32).contiguous()
    err = getattr(q8_v1, qt._Q8_ENTRY[x_dtype])(
        x.data_ptr(), w["q"].data_ptr(), s.data_ptr(), want.data_ptr(), m, k,
        n, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 1280, 51866), (8, 5120, 1280),
                                   (256, 1280, 51866), (64, 5120, 1280)])
def test_k6_kernel_is_deterministic(cuda, m, k, n, x_dtype):
    """Two calls on the same inputs give the same bits (the TPU kernel's
    result does not change from run to run): the split-K partials are
    summed in a fixed order, at the logit shape and at fc2, for the decode
    (M = 8) and the prefill (M = 64, 256) kernels. The output comes from
    an allocation that held NaNs just before, so an element the kernel
    did not write would show."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(x_dtype)
    w = _q8_weight(k, n, cuda, seed=k + n)
    outs = []
    for _ in range(2):
        junk = torch.full((m, n), float("nan"), device=cuda)
        del junk          # the caching allocator hands this block out next
        outs.append(qt.q8_matmul(x, w))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0]).all())
    assert torch.equal(outs[0], outs[1])


def test_int8_decoder_on_card_takes_decode_kernels(cuda, monkeypatch):
    """A d=128 dh=64 int8 decoder on the card with the three knobs on:
    int8 cross-KV (K5, K6) and the packed layout (K4, K6) each launch what
    the gates predict, and at f32 compute the greedy tokens equal the same
    model's run on the CPU (plain versions)."""
    from nobs_whisper_torch.decode.greedy import decode_window
    from nobs_whisper_torch.decode.rules import (DecodeOptions,
                                                 build_rule_tables)
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    for knob in ("NWT_XATTN_KERNEL", "NWT_Q8_KV_PALLAS",
                 "NWT_Q8_KERNEL_MIN_BYTES"):
        monkeypatch.setenv(knob, "1")
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=160, n_text_ctx=64)
    params = quantize_decoder_params(tw.init_params(6, cfg))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(cuda))
    xa = torch.from_numpy(np.random.RandomState(6).randn(
        2, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base, cfg.transcribe]] * 2
    for opts in (DecodeOptions(q8_cross_kv=True),
                 DecodeOptions(xattn_bf16=True)):
        tables = build_rule_tables(cfg, opts)
        counts = lambda: (ap.k4_launch_count, ap.k5_launch_count,
                          qt.k6_launch_count)
        before = counts()
        tw.decoder_forward_calls.clear()
        got = decode_window(to_dev(params), xa.to(cuda), prompts, cfg,
                            tables, opts)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(counts(), before)]
        calls = dict(tw.decoder_forward_calls)
        layout = "q8" if opts.q8_cross_kv else "packed"
        single = sum(c for (lay, _, s), c in calls.items() if s == 1)
        # 2 x 160 cross-KV rows: over 256, so K6 is not taken there
        assert launched == [
            cfg.n_text_layer * single * (layout == "packed"),
            cfg.n_text_layer * single * (layout == "q8"),
            (8 * cfg.n_text_layer + 1) * sum(calls.values())]
        ref = decode_window(params, xa, prompts, cfg, tables, opts)
        assert [r.tokens for r in got] == [r.tokens for r in ref]


# ---------------------------------------------------------------------------
# the encoder knobs' kernels: K10, K11, K8 and K13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(300, 256), (3000, 1280), (1500, 1280)])
def test_k10_k11_kernels_match_plain(cuda, m, d, x_dtype):
    """Ragged m (300 is not a multiple of the 128-row tile) and the
    large-v3-turbo width at two windows and at one window of 1500 rows."""
    x, g, be, wq, bq, wk, wv, bv = _k1_inputs(1, 2, m, d, cuda, seed=m)
    x = x[0].to(x_dtype)
    before = (fq.k10_launch_count, fq.k10_launch_count_f32)
    got = fq.encoder_qkv_int8(x, g, be, wq, bq, wk, wv, bv)
    torch.cuda.synchronize()
    f32 = int(x_dtype == torch.float32)
    assert (fq.k10_launch_count, fq.k10_launch_count_f32) == \
        (before[0] + 1, before[1] + f32)
    ref = fq.encoder_qkv_int8_plain(x, g, be, wq, bq, wk, wv, bv)
    for z, r in zip(got, ref):
        assert z.dtype == x_dtype and z.shape == r.shape
        assert (z.float() - r.float()).abs().max().item() < K2_TOL
    a = (torch.randn(m, d, device=cuda) * 0.5).to(x_dtype)
    before = fq.k11_launch_count
    got = fq.residual_o_int8(x, a, wq, bq)
    torch.cuda.synchronize()
    assert fq.k11_launch_count == before + 1
    ref = fq.residual_o_int8_plain(x, a, wq, bq)
    assert got.dtype == x_dtype
    assert (got.float() - ref.float()).abs().max().item() < K2_TOL


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,f,block_f", [
    (300, 256, 512, 128), (2 * 1536, 1280, 5120, 1280),
    # the knob path's rows: 1500 per window, the last 128-row tile ragged
    (2 * 1500, 1280, 5120, 1280), (1500, 1280, 5120, 1280)])
def test_k8_kernel_matches_plain(cuda, m, d, f, block_f, x_dtype):
    args = _k2_inputs(m, d, f, cuda)
    args = (args[0].to(x_dtype),) + args[1:]
    before = (fm.k8_launch_count, fm.launch_count)
    got = fm.encoder_mlp_int8(*args, block_f=block_f)
    torch.cuda.synchronize()
    assert (fm.k8_launch_count, fm.launch_count) == (before[0] + 1,
                                                      before[1])
    ref = fm.encoder_mlp_int8_plain(*args, block_f=block_f)
    assert got.dtype == x_dtype
    assert (got.float() - ref.float()).abs().max().item() < K2_TOL


@pytest.fixture(scope="module")
def mma_sync_mlp():
    """The port's first K2/K8 kernels (``tests/goldens/
    fused_mlp_mma_sync.cu``: mma.sync GEMMs, fc1's f32 output through
    device memory, a requant pass), built on the card: the bits that the
    wgmma kernels of ``csrc/fused_mlp.cu`` must give."""
    return _golden("fused_mlp_mma_sync.cu", "goldens", fm._SIG)


def _golden(name, out, signatures, header="common_mma_sync.cuh"):
    """Build ``tests/goldens/<name>`` on the card beside a copy of its
    frozen ``common.cuh`` (``common_mma_sync.cuh``, where the first mma.sync
    GEMMs lived, or ``common_v1.cuh`` for the decode kernels' first
    versions) and load it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    import os
    import shutil
    from nobs_whisper_torch.ops import _build
    here = os.path.join(os.path.dirname(__file__), "goldens")
    out = os.path.join(_build.BUILD_DIR, out)
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(here, header), out)
    lib_name = name.split(".")[0]
    with open(os.path.join(here, name)) as f:
        libs, _ = _build.build_variants({lib_name: f.read()}, out,
                                        signatures)
    return libs[lib_name]


def _mma_sync_call(lib, key, args, block_f):
    """``args`` through the mma.sync kernel's C entry of ``key``: the
    weights in the (d_in, d_out) layout and the full f32 workspace."""
    x, g, be, fc1, b1, fc2, b2 = args
    m, d = x.shape
    ffn = fc1["q"].shape[-1]
    dev = x.device
    out = torch.empty_like(x)
    ws = [torch.empty((m, d), dtype=torch.int8, device=dev),
          torch.empty((m,), dtype=torch.float32, device=dev),
          torch.empty((m, ffn), dtype=torch.float32, device=dev),
          torch.empty((m, ffn // block_f), dtype=torch.int32, device=dev),
          torch.empty((m, ffn), dtype=torch.int8, device=dev)]
    s1 = fc1["s"].reshape(ffn).contiguous()
    s2 = fc2["s"].reshape(d).contiguous()
    ops = [x, g, be, fc1["q"], s1, b1, fc2["q"], s2, b2, out, *ws]
    err = getattr(lib, fm._ENTRY[key, x.dtype])(
        *(z.data_ptr() for z in ops), m, d, ffn, block_f,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


# (ffn, block_f): the whole FFN as one chunk and 3072 of 3072, which no
# cluster of at most 16 blocks covers (the two-pass variant, fm.fc1_plan),
# the call sites' chunks, and 128-column tiles (256)
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [3072, 3000, 1500, 333])
@pytest.mark.parametrize("f,block_f", [
    (5120, 5120), (5120, 2560), (5120, 1280), (5120, 640), (5120, 256),
    (3072, 3072)])
@pytest.mark.parametrize("key", ["K2", "K8"])
def test_k2_k8_wgmma_bits(cuda, mma_sync_mlp, key, f, block_f, m, x_dtype):
    """K2 and K8 at large-v3-turbo width (d = 1280, ffn = 5120), at every
    chunk width the fc1 plan distinguishes, the rows of a batch of two
    windows, of two and one windows of 1500, and a ragged count: within
    K2's 0.05 of the plain version, the same bits from two calls, and the
    same bits as the port's first (mma.sync) kernel."""
    args = _k2_inputs(m, 1280, f, cuda, seed=m + block_f)
    args = (args[0].to(x_dtype),) + args[1:]
    fn = fm.encoder_mlp_int8 if key == "K8" else fm.encoder_mlp_int8_resident
    got = fn(*args, block_f=block_f)
    again = fn(*args, block_f=block_f)
    gold = _mma_sync_call(mma_sync_mlp, key, args, block_f)
    torch.cuda.synchronize()
    assert got.dtype == x_dtype and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    assert torch.equal(got, gold), (got.float() - gold.float()).abs().max()
    ref = fm.mlp_int8_plain(*args, block_f)
    err = (got.float() - ref.float()).abs().max().item()
    assert err < K2_TOL, err


def test_k_major_copy_made_once(cuda, monkeypatch):
    """The K-major copies are made at a QTensor's first launch and kept:
    a second launch finds the same tensors. K2's fc1/fc2 through its
    wrapper; the int8 encoder's stacked weights, which ``_encode`` copies
    once at its first call on the card: q/k/v/o with ``NWT_INT8_QKV`` (K10,
    K11), q/k/v on the default path (K1, with K2's fc1/fc2), and all six
    with ``NWT_ATTN_FUSED=3`` (K12)."""
    args = _k2_inputs(256, 256, 512, cuda)
    assert "qt" not in args[3] and "qt" not in args[5]
    fm.encoder_mlp_int8_resident(*args, block_f=256)
    first = (args[3]["qt"], args[5]["qt"])
    fm.encoder_mlp_int8_resident(*args, block_f=256)
    assert args[3]["qt"] is first[0] and args[5]["qt"] is first[1]
    assert torch.equal(first[0], args[3]["q"].t())

    qkv, mlp = ("q_w", "k_w", "v_w"), ("fc1_w", "fc2_w")
    _copies_made_once(cuda, monkeypatch, {"NWT_INT8_QKV": "1"},
                      torch.float32, qkv + ("o_w",) + mlp,
                      lambda: (fq.k10_launch_count, fq.k11_launch_count))
    _copies_made_once(cuda, monkeypatch, {}, torch.bfloat16, qkv + mlp,
                      lambda: (ea.launch_count, fm.launch_count))
    _copies_made_once(cuda, monkeypatch, {"NWT_ATTN_FUSED": "3"},
                      torch.bfloat16, qkv + ("o_w",) + mlp,
                      lambda: (fl.launch_count,))


def _copies_made_once(cuda, monkeypatch, knobs, dtype, names, counts):
    """A tiny int8 encoder on the card with ``knobs`` set: each kernel of
    ``counts`` launched once a layer; the stacked weights ``names``, and no
    other, hold their K-major copies after the first ``encode``, and a
    second finds the same tensors and gives the same states."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.utils.testing import tiny_test_config
    with monkeypatch.context() as m:
        for k, v in knobs.items():
            m.setenv(k, v)
        cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
        params = qt.quantize_encoder_params(tw.init_params(2, cfg,
                                                           device=cuda))
        blocks = params["encoder"]["blocks"]
        quantized = [n for n, w in blocks.items() if qt.is_quantized(w)]
        assert not any("qt" in blocks[n] for n in quantized)
        mel = torch.randn(2, cfg.n_mels, 2 * cfg.n_audio_ctx, device=cuda)
        before = counts()
        want = tw.encode(params, mel, cfg, compute_dtype=dtype)
        assert counts() == tuple(c + cfg.n_audio_layer for c in before)
        assert sorted(n for n in quantized if "qt" in blocks[n]) == sorted(
            names)
        first = [blocks[n]["qt"] for n in names]
        for n, t in zip(names, first):
            assert t.is_contiguous()
            assert torch.equal(t, blocks[n]["q"].transpose(-1, -2))
        assert torch.equal(tw.encode(params, mel, cfg, compute_dtype=dtype),
                           want)
        assert all(blocks[n]["qt"] is t for n, t in zip(names, first))


@pytest.fixture(scope="module")
def mma_sync_qkv():
    """The port's first K10/K11 kernels (``tests/goldens/
    fused_qkv_mma_sync.cu``: a scalar-load quantization pass and
    ``mma.sync`` GEMMs, with ``tests/goldens/common_mma_sync.cuh``, the
    ``common.cuh`` they were built with), built on the card: the bits
    that the wgmma kernels of ``csrc/fused_qkv.cu`` must give."""
    return _golden("fused_qkv_mma_sync.cu", "goldens_qkv", fq._SIG)


def _mma_sync_qkv_call(lib, key, args):
    """``args`` through the mma.sync kernels' C entry of ``key``: the
    weights in the (d_in, d_out) layout."""
    x = args[0]
    m, d = x.shape
    f32 = lambda z: z.float().contiguous().reshape(-1)
    xq, sx = fq.qkv_workspace(m, d, x.device)
    if key == "K11":
        _, a, wo, bo = args
        outs = [torch.empty_like(x)]
        ops = [x, a, wo["q"], f32(wo["s"]), f32(bo), outs[0], xq, sx]
    else:
        _, g, be, wq, bq, wk, wv, bv = args
        outs = [torch.empty_like(x) for _ in range(3)]
        ops = [x, f32(g), f32(be), wq["q"], f32(wq["s"]), f32(bq), wk["q"],
               f32(wk["s"]), wv["q"], f32(wv["s"]), f32(bv), *outs, xq, sx]
    err = getattr(lib, fq._ENTRY[key, x.dtype])(
        *(z.data_ptr() for z in ops), m, d,
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return outs


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(3000, 1280), (1500, 1280), (333, 1280),
                                 (300, 1280), (3000, 256), (1500, 256),
                                 (333, 256), (300, 256)])
def test_k10_k11_wgmma_bits(cuda, mma_sync_qkv, m, d, x_dtype):
    """K10 and K11 at large-v3-turbo width and at d = 256 (128-column tiles
    only), at the knob path's rows (two and one windows of 1500) and two
    ragged counts: the same bits from two calls, the same bits as the
    port's first (mma.sync) kernels, and within ``K2_TOL`` of the plain
    versions."""
    x, g, be, wq, bq, wk, wv, bv = _k1_inputs(1, 2, m, d, cuda, seed=m + d)
    x = x[0].to(x_dtype)
    a = (torch.randn(m, d, device=cuda) * 0.5).to(x_dtype)
    for key, args, fn, plain in (
            ("K10", (x, g, be, wq, bq, wk, wv, bv), fq.encoder_qkv_int8,
             fq.encoder_qkv_int8_plain),
            ("K11", (x, a, wq, bq), fq.residual_o_int8,
             fq.residual_o_int8_plain)):
        got = fn(*args)
        got = list(got) if key == "K10" else [got]
        again = fn(*args)
        again = list(again) if key == "K10" else [again]
        gold = _mma_sync_qkv_call(mma_sync_qkv, key, args)
        torch.cuda.synchronize()
        ref = plain(*args)
        ref = list(ref) if key == "K10" else [ref]
        for z, z2, zg, r in zip(got, again, gold, ref):
            assert z.dtype == x_dtype and torch.isfinite(z.float()).all()
            assert torch.equal(z, z2), key
            assert torch.equal(z, zg), (key, (z.float() - zg.float()).abs()
                                        .max().item())
            err = (z.float() - r.float()).abs().max().item()
            assert err < K2_TOL, (key, err)


def _k13_inputs(b, c_in, n_frames, d, dev, p_dtype=torch.bfloat16, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s, sc=1.0: torch.from_numpy(
        (rng.randn(*s) * sc).astype(np.float32)).to(dev)
    mel = mk(b, c_in, n_frames, sc=0.5)
    return (mel, *[z.to(p_dtype) for z in (
        mk(3, c_in, d, sc=(3 * c_in) ** -0.5), mk(d, sc=0.1),
        mk(3, d, d, sc=(3 * d) ** -0.5), mk(d, sc=0.1),
        mk(n_frames // 2, d, sc=0.1))])


@pytest.mark.parametrize("b,c_in,n_frames,d,t_pad", [
    (1, 80, 64, 128, 32), (2, 80, 64, 128, 48), (1, 128, 100, 256, 56),
    (2, 128, 3000, 1280, 1536), (2, 128, 3000, 1280, 1504),
    (1, 80, 3000, 1280, 1536),
    (1, 80, 64, 384, 32),            # d = 384: 128-column tiles only
    (2, 128, 200, 768, 104),         # t_real = 100, under one 128-row tile
    (8, 128, 3000, 1280, 1536),      # the serving batcher's max_batch
    (2, 80, 200, 256, 400)])         # 300 zero rows: whole tiles of zeros
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_k13_kernel_matches_plain(cuda, b, c_in, n_frames, d, t_pad,
                                  p_dtype):
    """Weights, biases and pos as f32 or bf16: the wrapper converts what
    the kernel does not read as it lies, and each copy must live until the
    launch."""
    args = (*_k13_inputs(b, c_in, n_frames, d, cuda, p_dtype,
                         seed=c_in + t_pad), t_pad)
    before = cs.launch_count
    got = cs.encoder_stem_fused(*args)
    torch.cuda.synchronize()
    assert cs.launch_count == before + 1
    ref = cs.encoder_stem_fused_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == (b, t_pad, d)
    assert not got[:, n_frames // 2:].any()      # padded rows: exact zeros
    assert (got.float() - ref.float()).abs().max().item() < 3e-2


@pytest.mark.parametrize("b,c_in,n_frames,d,t_pad", [
    (2, 128, 3000, 1280, 1536), (1, 80, 200, 384, 104)])
def test_k13_kernel_is_deterministic(cuda, b, c_in, n_frames, d, t_pad):
    """No split sum and no atomics: two calls give the same bits."""
    args = (*_k13_inputs(b, c_in, n_frames, d, cuda, seed=1), t_pad)
    first = cs.encoder_stem_fused(*args)
    assert torch.equal(first, cs.encoder_stem_fused(*args))


def test_k13_launches_only_its_kernels(cuda):
    """With bf16 weights, biases and pos (as the serving engine holds
    them), a call copies nothing: it launches the stem's own kernels, one
    mel pass and the two convs, and nothing else."""
    from torch.profiler import ProfilerActivity, profile
    args = (*_k13_inputs(2, 128, 3000, 1280, cuda, seed=2), 1536)
    cs.encoder_stem_fused(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cs.encoder_stem_fused(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    print(names)
    assert all("stem_" in n for n in names), names
    assert sum("stem_mel_rows" in n for n in names) == 1, names
    assert sum("stem_conv" in n for n in names) == 2, names


def test_k13_refuses_what_it_cannot_take(cuda):
    """On a CUDA tensor the wrapper launches the kernel or raises: no
    fallback to the plain version."""
    mel, w1, b1, w2, b2, pos = _k13_inputs(1, 80, 64, 128, cuda)
    with pytest.raises(ValueError):
        cs.encoder_stem_fused(mel, w1, b1, w2[:, :64], b2, pos, 32)
    with pytest.raises(ValueError):
        cs.encoder_stem_fused(mel, w1.cpu(), b1, w2, b2, pos, 32)
    with pytest.raises(ValueError):
        cs.encoder_stem_fused(mel, w1, b1, w2, b2, pos[:16], 32)
    with pytest.raises(AssertionError):
        cs.encoder_stem_fused(mel[..., :63], w1, b1, w2, b2, pos, 32)


# ---------------------------------------------------------------------------
# K1 with fused o, K12, and the int8 scores and PV of K1, K3 and K12
# ---------------------------------------------------------------------------

INT8 = {"i8s": (True, False), "i8pv": (False, True), "both": (True, True)}
ALL = {"none": (False, False), **INT8}
# The variants' tolerances on the card (kernel against plain, both on the
# card). K3 and the attention-only K1 variants: the int8 dots are exact in
# both; the f32 order of the bf16 dots and sums differs, and a flip of
# LN1's int8 activation (K1) in the row that holds a head's absmax of k or
# v moves that head's scale, so every row of the head moves a little: max
# 2e-2 (the JAX tests' K1 ceiling), mean 1e-4 (readings at turbo width:
# max 5.4e-3, mean 8.0e-6). After an int8 requantization of the f32 result
# (fused o) an int8 flip moves a row by an int8 step times a weight: 5e-2
# (K2's bound), mean 2e-4 (with int8 scores at turbo width: mean 1.02e-4,
# where a moved head scale feeds the requantization). K12 end to end: its
# bf16 x2 differs from the plain one by a bf16 step in 7% of the elements
# at turbo width (one int8 flip of the o input moves its whole row by
# about half a bf16 step), so most rows, and LN2 requantizes each such
# row: max 1e-1, mean 5e-3 (readings at turbo width: max 5.5e-2, mean
# 3.5e-3, half the elements differ); K12 is besides held bit for bit
# to its two halves' kernels and its MLP half, on the kernel's own x2, to
# K2's bound (:func:`test_k12_kernel_is_fused_o_then_k2`).
VAR_TOL = {"attn": (2e-2, 1e-4), "o": (5e-2, 2e-4), "K12": (1e-1, 5e-3)}


def _var_close(got, ref, n_real, kind):
    tol, mean = VAR_TOL[kind]
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()         # padded rows included
    diff = (got.float() - ref.float())[:, :n_real].abs()
    print(f"{kind}: max {diff.max().item():.3e} mean "
          f"{diff.mean().item():.3e}")
    assert diff.max().item() < tol
    assert diff.mean().item() < mean


def _launched(fn, key, name):
    """Run ``fn`` and check that it launched the named variant once."""
    counter = (fl.variant_launch_count if key == "K12"
               else ea.variant_launch_count)
    before = dict(counter), fl.launch_count, ea.launch_count
    got = fn()
    torch.cuda.synchronize()
    want = dict(before[0])
    want[name] = want.get(name, 0) + 1
    if name == "K12":
        assert fl.launch_count == before[1] + 1 and dict(counter) == before[0]
    else:
        assert dict(counter) == want
    assert ea.launch_count == before[2]        # the default K1: not launched
    return got


@pytest.mark.parametrize("b,t,h,n_real", [
    (2, 256, 4, 256), (2, 256, 4, 250), (1, 256, 2, 40),
    (2, 192, 4, 150),                       # T % 128 == 64: a half block
    (2, 256, 4, 230),                       # n_real inside the last k32 step
    (2, 1536, 20, 1500),                    # large-v3-turbo width
])
@pytest.mark.parametrize("var", list(INT8))
def test_k3_int8_variants_kernel_match_plain(cuda, var, b, t, h, n_real):
    s8, pv = INT8[var]
    q, k, v = _attn_inputs((b, t, h * 64), cuda, seed=t + n_real + 7)
    name = ea.variant("K3", False, s8, pv)
    got = _launched(lambda: ea.encoder_attention_btd(
        q, k, v, n_real, 0.125, h, int8_scores=s8, int8_pv=pv), "K3", name)
    ref = ea.encoder_attention_btd_plain(q, k, v, n_real, 0.125, h, s8, pv)
    _var_close(got, ref, n_real, "attn")


K1_SHAPES = [(2, 4, 256, 256, 256), (2, 4, 256, 256, 250),
             (1, 6, 128, 384, 128),              # many head pairs
             (2, 4, 192, 256, 150),              # T % 128 == 64: a half block
             (2, 4, 256, 256, 230),              # n_real in the last k32 step
             (2, 20, 1536, 1280, 1500)]          # turbo: 1500 real in 1536
# Every variant at every shape but one: K1 with the o projection and both
# int8 variants at the half-block shape comes out just above the fused o's
# 2e-4 mean bound (few elements, so a few flipped int8 activations move
# the mean; ROADMAP.md section 3, "Limits of the checks").
K1_CASES = [(fuse_o, var, *shape) for shape in K1_SHAPES for var in ALL
            for fuse_o in (False, True)
            if not (fuse_o and var == "both" and shape[2] % 128 == 64)]


@pytest.mark.parametrize(
    "fuse_o,var,b,h,t,d,n_real", K1_CASES,
    ids=["-".join(map(str, c)) for c in K1_CASES])
def test_k1_variants_kernel_match_plain(cuda, fuse_o, var, b, h, t, d,
                                        n_real):
    """K1's int8 scores, int8 PV, and the fused o projection, alone and
    together. The plain version quantizes the f32 q projection before the
    softmax scale, so a kernel that quantized a bf16 or pre-scaled q would
    move many int8 q values, the turbo case's ragged 1500-in-1536 rows
    included."""
    s8, pv = ALL[var]
    if not (fuse_o or s8 or pv):
        pytest.skip("the default K1: test_k1_kernel_matches_plain")
    args = _k1_inputs(b, h, t, d, cuda, seed=11)
    wo = quantize_int8(torch.randn(d, d, device=cuda) * d ** -0.5)
    bo = 0.1 * torch.randn(d, device=cuda)
    kw = dict(wo=wo, bo=bo) if fuse_o else {}
    name = ea.variant("K1", fuse_o, s8, pv)
    got = _launched(lambda: ea.encoder_attention_fused_qkv(
        *args, n_real, 0.125, h, int8_scores=s8, int8_pv=pv, **kw), "K1",
        name)
    ref = ea.encoder_attention_fused_qkv_plain(
        *args, n_real, 0.125, h, int8_scores=s8, int8_pv=pv, **kw)
    _var_close(got, ref, n_real, "o" if fuse_o else "attn")


def test_k1_fused_o_half_block_matches_plain(cuda):
    """K1 with the o projection fused at T % 128 == 64: the bf16 attention
    kernel's last block of 128 query rows has one warpgroup's rows, and its
    f32 output feeds the per-pair requantization."""
    b, h, t, d, n_real = 2, 4, 192, 256, 150
    args = _k1_inputs(b, h, t, d, cuda, seed=11)
    wo = quantize_int8(torch.randn(d, d, device=cuda) * d ** -0.5)
    bo = 0.1 * torch.randn(d, device=cuda)
    got = _launched(lambda: ea.encoder_attention_fused_qkv(
        *args, n_real, 0.125, h, wo=wo, bo=bo), "K1", "K1-o")
    ref = ea.encoder_attention_fused_qkv_plain(*args, n_real, 0.125, h,
                                               wo=wo, bo=bo)
    _var_close(got, ref, n_real, "o")


def _layer_inputs(b, h, t, d, f, dev, seed=20):
    x, g1, b1n, wq, bq, wk, wv, bv = _k1_inputs(b, h, t, d, dev, seed)
    _, g2, b2n, fc1, fc1_b, fc2, fc2_b = _k2_inputs(8, d, f, dev, seed + 1)
    wo = quantize_int8(torch.randn(d, d, device=dev) * d ** -0.5)
    bo = 0.1 * torch.randn(d, device=dev)
    return (x, g1, b1n, wq, bq, wk, wv, bv, wo, bo, g2, b2n, fc1, fc1_b, fc2,
            fc2_b)


@pytest.mark.parametrize("b,h,t,d,f,block_f,n_real", [
    (2, 4, 256, 256, 512, 256, 250),
    (1, 6, 128, 384, 1536, 768, 128),
    (2, 20, 1536, 1280, 5120, 1280, 1500),   # large-v3-turbo, K12's chunk
])
@pytest.mark.parametrize("var", list(ALL))
def test_k12_kernel_matches_plain(cuda, var, b, h, t, d, f, block_f,
                                  n_real):
    s8, pv = ALL[var]
    args = _layer_inputs(b, h, t, d, f, cuda)
    name = ea.variant("K12", False, s8, pv)
    got = _launched(lambda: fl.encoder_layer_fused(
        *args, n_real, 0.125, h, block_f=block_f, int8_scores=s8,
        int8_pv=pv), "K12", name)
    ref = fl.encoder_layer_fused_plain(*args, n_real, 0.125, h,
                                       block_f=block_f, int8_scores=s8,
                                       int8_pv=pv)
    _var_close(got, ref, n_real, "K12")


@pytest.mark.parametrize("knobs,want", [
    ({"NWT_ATTN_FUSED": "2"}, {"K1-o": 2, "K2": 2}),
    ({"NWT_ATTN_FUSED": "3"}, {"K12": 2}),
    ({"NWT_ATTN_FUSED": "3", "NWT_ATTN_I8": "1", "NWT_ATTN_I8PV": "1"},
     {"K12-i8s-i8pv": 2}),
    ({"NWT_ATTN_I8": "1"}, {"K1-i8s": 2, "K2": 2}),
])
def test_int8_encoder_on_card_takes_the_variants(cuda, monkeypatch, knobs,
                                                 want):
    """The d=128 dh=64 int8 encoder on the card with the variant knobs:
    the variant's kernel once per layer, states within 5e-2 of the same
    encoder on the CPU."""
    from nobs_whisper_torch.models import whisper as tw
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    params = quantize_encoder_params(
        tw.init_params(3, cfg, dtype=torch.bfloat16))
    mel = torch.from_numpy(
        np.random.RandomState(4).randn(2, 80, 64).astype(np.float32))
    to_dev = lambda t: ({k: to_dev(v) for k, v in t.items()}
                        if isinstance(t, dict) else t.to(cuda))
    counts = lambda: dict(ea.variant_launch_count, K1=ea.launch_count,
                          K2=fm.launch_count, K12=fl.launch_count,
                          **fl.variant_launch_count)
    before = counts()
    got = tw.encode(to_dev(params), mel.to(cuda), cfg,
                    compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    after = counts()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if v != before.get(k, 0)}
    assert moved == want
    ref = tw.encode(params, mel, cfg, compute_dtype=torch.bfloat16)
    assert torch.isfinite(got.float()).all()
    err = (got.float().cpu() - ref.float()).abs().max().item()
    assert err < 5e-2, err


@pytest.mark.parametrize("b,h,t,d,f,block_f,n_real", [
    (2, 4, 256, 256, 512, 256, 250),
    (2, 20, 1536, 1280, 5120, 1280, 1500),
])
@pytest.mark.parametrize("var", list(ALL))
def test_k12_kernel_is_fused_o_then_k2(cuda, var, b, h, t, d, f, block_f,
                                       n_real):
    """K12 on the card is K1 with fused o then K2 at K12's chunk, bit for
    bit (the same kernels on one stream; the atomics are max over float
    bits, exact); its MLP half on the kernel's own x2 is K2's plain
    version within K2's bound of 5e-2."""
    s8, pv = ALL[var]
    args = _layer_inputs(b, h, t, d, f, cuda)
    got = fl.encoder_layer_fused(*args, n_real, 0.125, h, block_f=block_f,
                                 int8_scores=s8, int8_pv=pv)
    x2 = ea.encoder_attention_fused_qkv(
        *args[:8], n_real, 0.125, h, int8_scores=s8, int8_pv=pv,
        wo=args[8], bo=args[9]).reshape(b * t, d)
    want = fm.encoder_mlp_int8_resident(x2, *args[10:], block_f=block_f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want.reshape(b, t, d), rtol=0, atol=0)
    half = fm.encoder_mlp_int8_resident_plain(x2, *args[10:],
                                              block_f=block_f)
    err = (got.float().reshape(b * t, d) - half.float()).abs()
    err = err.reshape(b, t, d)[:, :n_real].max().item()
    assert err < K2_TOL, err


@pytest.fixture(scope="module")
def mma_sync_k1():
    """The port's first K1 projections (``tests/goldens/
    k1_proj_mma_sync.cu``: LN1 + quantization and the q/k/v GEMM, the
    per-pair quantization and the o GEMM, on ``mma.sync``, the weights as
    stored), built on the card: the bits that K1's and K12's int8
    ``wgmma`` projections (``csrc/proj_wgmma.cuh``) must give."""
    import ctypes
    P, I = ctypes.c_void_p, ctypes.c_int
    return _golden("k1_proj_mma_sync.cu", "goldens_k1", {
        "nwt_k1_qkv_mma_sync": [P] * 16 + [ctypes.c_float, I, I, I, P],
        "nwt_k1_o_mma_sync": [P] * 8 + [I, I, P]})


def _k1_operands(monkeypatch, fn):
    """Run ``fn`` (a K1 or K12 wrapper call) and return its output and the
    28 operands of K1's C entry that the wrapper made (its workspace: the
    quantized rows, q, k, v, the f32 attention output and its int8 copy)."""
    seen, real = [], ea.fused_qkv_operands

    def spy(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    with monkeypatch.context() as m:
        m.setattr(ea, "fused_qkv_operands", spy)
        out = fn()
    torch.cuda.synchronize()
    return out, seen[-1]


# (b, h, t, d, n_real): turbo's two windows and one, the T % 128 == 64
# block at d = 256, and a turbo T that is no multiple of 128
K1_BITS = [(2, 20, 1536, 1280, 1500), (1, 20, 1536, 1280, 1500),
           (2, 4, 192, 256, 150), (1, 20, 1472, 1280, 1450)]
K1_BITS_CASES = [(key, flags, *g) for g in K1_BITS for key in ("K1", "K12")
                 for flags in range(8) if key == "K1" or flags & 4]


@pytest.mark.parametrize("key,flags,b,h,t,d,n_real", K1_BITS_CASES,
                         ids=["-".join(map(str, c)) for c in K1_BITS_CASES])
def test_k1_k12_wgmma_bits(cuda, monkeypatch, mma_sync_k1, mma_sync_mlp,
                           key, flags, b, h, t, d, n_real):
    """K1 (every flag: 1 int8 scores, 2 int8 PV, 4 the o projection fused)
    and K12 (flags 4-7) give the bits of the port's first, mma.sync
    projections: LN1's int8 rows and scales (K1's; K12's LN2 writes the
    same scratch after them), q (bf16 and pre-scaled, or
    f32 and unscaled under int8 scores), k and v bit for bit; with the o
    projection fused, the per-pair int8 rows and scales and x + attention
    @ wo + bo, on the kernel's own f32 attention output, bit for bit; K12's
    layer bit for bit the first K2 on that. Between the two, the attention
    is the same kernel before and after, so K1's output is the parent's;
    without int8 scores or the fused o it is besides K3 on the mma.sync
    q, k and v (K3 at scale 1 on q scaled already). Two calls give the
    same bits."""
    import ctypes
    s8, pv, fuse_o = bool(flags & 1), bool(flags & 2), bool(flags & 4)
    f, bf = (5120, 1280) if d == 1280 else (512, 256)
    args = _layer_inputs(b, h, t, d, f, cuda, seed=t + flags)
    sm = float(d // h) ** -0.5
    kw = dict(int8_scores=s8, int8_pv=pv)
    if key == "K12":
        fn = lambda: fl.encoder_layer_fused(*args, n_real, sm, h,
                                            block_f=bf, **kw)
    else:
        o = dict(wo=args[8], bo=args[9]) if fuse_o else {}
        fn = lambda: ea.encoder_attention_fused_qkv(*args[:8], n_real, sm, h,
                                                    **kw, **o)
    got, ops = _k1_operands(monkeypatch, fn)
    again = fn()
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.isfinite(got.float()).all()

    m = b * t
    x, g, be, wq, bq, wk, wv, bv, wo, bo = args[:10]
    f32 = lambda z: z.float().contiguous().reshape(-1)
    q = torch.empty((m, d), device=cuda,
                    dtype=torch.float32 if s8 else torch.bfloat16)
    k, v = (torch.empty((m, d), device=cuda, dtype=torch.bfloat16)
            for _ in range(2))
    xq, sx = fq.qkv_workspace(m, d, cuda)
    st = torch.cuda.current_stream().cuda_stream
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = mma_sync_k1.nwt_k1_qkv_mma_sync(
        *(ptr(z) for z in (x, f32(g), f32(be), wq["q"], f32(wq["s"]), f32(bq),
                           wk["q"], f32(wk["s"]), wv["q"], f32(wv["s"]),
                           f32(bv), q, k, v, xq, sx)),
        ctypes.c_float(1.0 if s8 else sm), m, d, int(s8), ctypes.c_void_p(st))
    assert err == 0, err
    torch.cuda.synchronize()
    mine = {"q": ops[17], "k": ops[18], "v": ops[19]}
    if key == "K1":   # K12's LN2 reuses K1's quantized-row scratch
        mine.update(xq=ops[15], sx=ops[16])
    gold = {"xq": xq, "sx": sx, "q": q, "k": k, "v": v}
    for name, z in mine.items():
        assert torch.equal(z.reshape(gold[name].shape), gold[name]), name
    if not fuse_o:
        if not s8:
            k3 = ea.encoder_attention_btd(
                *(z.reshape(b, t, d) for z in (q, k, v)), n_real, 1.0, h,
                int8_pv=pv)
            torch.cuda.synchronize()
            assert torch.equal(got, k3)
        return

    out = torch.empty((m, d), device=cuda, dtype=torch.bfloat16)
    aq = torch.empty((m, d), device=cuda, dtype=torch.int8)
    sa = torch.empty((m, d // 128), device=cuda, dtype=torch.float32)
    err = mma_sync_k1.nwt_k1_o_mma_sync(
        *(ptr(z) for z in (ops[20], wo["q"], f32(wo["s"]), f32(bo), x, out,
                           aq, sa)), m, d, ctypes.c_void_p(st))
    assert err == 0, err
    torch.cuda.synchronize()
    assert torch.equal(ops[21], aq) and torch.equal(ops[22], sa)
    assert torch.equal(ops[14].reshape(m, d), out)
    if key == "K12":
        layer = _mma_sync_call(mma_sync_mlp, "K2", (out, *args[10:]), bf)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(m, d), layer)


# ---------------------------------------------------------------------------
# K14 and K7: ops that no serving path takes
# ---------------------------------------------------------------------------

K14_TOL = 1e-4


@pytest.mark.parametrize("b", [1, 2, 40])
@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_kernel_matches_plain(cuda, b, n_mels):
    """K14 on ``tone_burst_windows`` (3-27 s of bursts over a tone, then
    zeros, so the clamp matters) against the f64 oracle: 4e-4 on the raw
    log10 above each sample's max - 8, K14_TOL normalized. Not against its
    dense plain version or ``log_mel_spectrogram`` at those bounds: on this
    PCM their own f32 rounding is up to 1.0e-3 raw and 2.5e-4 normalized
    from the oracle (``scripts/k14_dense_error.py``), so a kernel that
    computes the exact function misses them by that much. Both distances
    are printed beside the check."""
    audio = torch.from_numpy(tone_burst_windows(b, seed=b + n_mels)).to(cuda)
    before = mp.k14_launch_count
    got = mp.log10_mel_pallas(audio, n_mels)
    torch.cuda.synchronize()
    assert mp.k14_launch_count == before + 1
    ref = mp.log10_mel_pallas_plain(audio, n_mels)
    assert got.shape == ref.shape == (b, 3000, n_mels)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    keep = ref > torch.amax(ref, dim=(1, 2), keepdim=True) - 8.0
    oracle = torch.from_numpy(np.stack([
        log_mel_numpy_f64(a, n_mels) for a in audio.cpu().numpy()])).to(cuda)
    raw64 = 4.0 * oracle.transpose(1, 2) - 4.0      # above the clamp
    norm = mp.log_mel_spectrogram_pallas(audio, n_mels)
    want = log_mel_spectrogram(audio, n_mels)
    assert norm.shape == want.shape == oracle.shape == (b, n_mels, 3000)
    print(f"raw above max - 8: |kernel - f64| "
          f"{(got - raw64).abs()[keep].max().item():.4e}, |kernel - plain| "
          f"{(got - ref).abs()[keep].max().item():.4e}, |plain - f64| "
          f"{(ref - raw64).abs()[keep].max().item():.4e}; normalized: "
          f"|kernel - f64| {(norm - oracle).abs().max().item():.4e}, "
          f"|kernel - log_mel_spectrogram| "
          f"{(norm - want).abs().max().item():.4e}")
    assert (got - raw64).abs()[keep].max() <= 4 * K14_TOL
    assert (norm - oracle).abs().max() <= K14_TOL


@pytest.mark.parametrize("n_mels", [80, 128])
def test_k14_silent_stretch_reaches_floor(cuda, n_mels):
    """A window of sound, 12 s of exact silence, then sound again: the
    silent frames' bins are exact zeros in the kernel's FFT, so their log10
    is the 1e-10 floor (-10) as in the plain version, and the frames
    around them (whose taps straddle the edges) match it as everywhere.
    Normalized, the kernel is held to the plain version and to the f64
    oracle at K14_TOL. Not to the port's ``log_mel_spectrogram`` on the
    card: that dense f32 DFT is itself up to ~1e-4 from the oracle here
    (chip_smoke.py's ``[ops]`` line), so the bound has no margin."""
    rng = np.random.RandomState(n_mels)
    pcm = np.zeros((1, 480000), np.float32)
    t = np.arange(480000) / 16000
    loud = (t < 8) | ((t >= 20) & (t < 26))
    pcm[0, loud] = (0.3 * np.sin(2 * np.pi * 440 * t[loud])
                    + 0.05 * rng.randn(int(loud.sum())))
    audio = torch.from_numpy(pcm).to(cuda)
    got = mp.log10_mel_pallas(audio, n_mels)
    ref = mp.log10_mel_pallas_plain(audio, n_mels)
    torch.cuda.synchronize()
    silent = slice(8 * 100 + 2, 20 * 100 - 2)    # frames whose taps are 0
    floor = torch.log10(torch.tensor(1e-10, device=cuda))
    assert (ref[0, silent] == floor).all()
    assert (got[0, silent] - floor).abs().max() <= 1e-6
    keep = ref > torch.amax(ref, dim=(1, 2), keepdim=True) - 8.0
    assert (got - ref).abs()[keep].max() <= 4 * K14_TOL
    norm = mp.log_mel_spectrogram_pallas(audio, n_mels)
    plain = ((torch.maximum(ref, torch.amax(ref, dim=(1, 2), keepdim=True)
                            - 8.0) + 4.0) / 4.0).transpose(1, 2)
    assert (norm - plain).abs().max() <= K14_TOL
    oracle = log_mel_numpy_f64(pcm[0], n_mels)
    assert np.abs(norm[0].cpu().numpy() - oracle).max() <= K14_TOL


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,ffn", [(1, 128, 512), (2, 128, 512),
                                     (8, 128, 512), (1, 1280, 5120),
                                     (2, 1280, 5120), (8, 1280, 5120),
                                     (11, 256, 1024), (16, 1280, 5120),
                                     (24, 1280, 5120)])
def test_k7_kernel_matches_plain(cuda, m, d, ffn, x_dtype):
    g = torch.Generator(device=cuda).manual_seed(m + d)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    x = rn(m, d).to(x_dtype)
    ln_g, ln_b = 1.0 + 0.1 * rn(d), 0.1 * rn(d)
    fc1, fc2 = quantize_int8(rn(d, ffn) * d ** -0.5), quantize_int8(
        rn(ffn, d) * ffn ** -0.5)
    b1, b2 = 0.1 * rn(ffn), 0.1 * rn(d)
    before = fm.k7_launch_count
    got = fm.fused_mlp_q8(x, ln_g, ln_b, fc1, b1, fc2, b2)
    torch.cuda.synchronize()
    assert fm.k7_launch_count == before + 1
    ref = fm.fused_mlp_q8_plain(x, ln_g, ln_b, fc1, b1, fc2, b2)
    assert got.shape == (m, d) and got.dtype == x_dtype
    if x_dtype == torch.bfloat16:
        _step_close(got, ref)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   **K6_TOL)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 24])
def test_k7_kernel_is_deterministic(cuda, m, x_dtype):
    """Two calls give the same bits, with fc2 by programmatic dependent
    launch and without it (the switch changes when fc2 starts, not what it
    sums); the outputs come from allocations that held NaNs just before."""
    g = torch.Generator(device=cuda).manual_seed(m)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    d, ffn = 1280, 5120
    x = rn(m, d).to(x_dtype)
    args = (x, 1.0 + 0.1 * rn(d), 0.1 * rn(d),
            quantize_int8(rn(d, ffn) * d ** -0.5), 0.1 * rn(ffn),
            quantize_int8(rn(ffn, d) * ffn ** -0.5), 0.1 * rn(d))
    outs = []
    try:
        for pdl in (True, True, False):
            fm.k7_set_pdl(pdl)
            junk = torch.full((m, d), float("nan"), device=cuda).to(x_dtype)
            del junk
            outs.append(fm.fused_mlp_q8(*args))
    finally:
        fm.k7_set_pdl(True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(outs[0].float()).all())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
