"""The encoder's last variants on the CPU: K1 with the o projection fused
(``NWT_ATTN_FUSED=2``), K12 (``encoder_layer_fused``, ``NWT_ATTN_FUSED=3``)
and the int8 scores and PV of K1, K3 and K12 (``NWT_ATTN_I8``,
``NWT_ATTN_I8PV``): the plain versions against the Pallas kernels in
interpret mode, at the JAX tests' shapes (tests/test_encoder_attention.py,
tests/test_fused_layer.py), and K12's gate at large-v3-turbo's width.

The port's wrappers run the plain versions for CPU tensors; on the card
they launch the CUDA kernels (tests/test_torch_kernels_gpu.py). Inputs are
made with numpy from a seed and cross as numpy arrays.

Tolerances, each measured (seeds as below):

* Attention outputs (K3, K1 without fused o): the plain versions repeat the
  kernels' rounding points; the int8 dots are exact; what is left is f32
  summation order (scores, softmax sum) and the f32 ``exp``, which can move
  one bf16 output step or one ``round(p * 127)`` at a .5 boundary. Held to
  one bf16 step elementwise (rtol 2^-7, atol 2^-9). Readings: at most 0.47
  of a step, max difference 2.0e-3.
* Outputs after an int8 requantization of an f32 result (K1 with fused o,
  K12): an f32 difference that moves one int8 activation moves its row by
  an int8 step times a weight. Held to :data:`KERNEL_TOL` 5e-2 and a mean
  of :data:`KERNEL_MEAN` 1e-4, as tests/test_torch_encoder_knobs.py holds
  K8, K10 and K11. Readings: max 7.8e-3 (fused o), mean at most 3.7e-6.
  The bf16 rounding of p before the PV dot makes the fused o projection's
  bf16 output sensitive to f32 order: computing the attention in float64
  instead moves one bf16 step in 0.2% of its elements. K12 puts a second
  requantization behind that: see :data:`K12_MEAN`.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nobs_whisper_tpu.ops import encoder_attention as jea
from nobs_whisper_tpu.ops import fused_layer as jfl
from nobs_whisper_tpu.ops.quant import quantize_int8 as jquantize_int8
from nobs_whisper_torch.core.config import WhisperConfig
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.models.whisper import params_from_jax
from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_layer as fl
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops.quant import quantize_int8

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
KERNEL_TOL, KERNEL_MEAN = 5e-2, 1e-4
INT8 = {"i8s": (True, False), "i8pv": (False, True), "both": (True, True)}
ALL = {"none": (False, False), **INT8}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for k in ("NWT_ATTN_S1", "NWT_ATTN_PV1"):
        monkeypatch.delenv(k, raising=False)


def _bf16_np(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _qt(w):
    return params_from_jax(jax.tree.map(np.asarray, w))


def _close(got, want, n_real):
    diff = np.abs(got - want)[:, :n_real]
    assert diff.max() < KERNEL_TOL, diff.max()
    assert diff.mean() < KERNEL_MEAN, diff.mean()


# ---------------------------------------------------------------------------
# K3: int8 scores, int8 PV and both (tests/test_encoder_attention.py:100-160)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_real", [256, 250])
@pytest.mark.parametrize("var", list(INT8))
def test_k3_int8_variants_plain_match_pallas_interpret(var, n_real):
    s8, pv = INT8[var]
    b, h, t, dh = 2, 4, 256, 64
    rng = np.random.RandomState(7)
    q, k, v = (_bf16_np(rng.randn(b, t, h * dh).astype(np.float32) * 0.5)
               for _ in range(3))
    ref = np.asarray(jea.encoder_attention_btd(
        *(jnp.asarray(z, jnp.bfloat16) for z in (q, k, v)), n_real, 0.125, h,
        block_q=128, int8_scores=s8, int8_pv=pv, interpret=True), np.float32)
    before = dict(ea.variant_launch_count)
    got = ea.encoder_attention_btd(
        *(torch.from_numpy(z).to(torch.bfloat16) for z in (q, k, v)),
        n_real, 0.125, h, int8_scores=s8, int8_pv=pv)
    assert dict(ea.variant_launch_count) == before   # plain: no launch
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()            # padded query rows too
    np.testing.assert_allclose(got[:, :n_real], ref[:, :n_real], **BF16_STEP)


# ---------------------------------------------------------------------------
# K1: int8 variants, fused o alone and with them
# ---------------------------------------------------------------------------

def _k1_case(b=2, h=4, t=256, d=256, seed=10):
    """tests/test_encoder_attention.py::_fused_setup, and an o projection."""
    rng = np.random.RandomState(seed)
    x = _bf16_np(rng.randn(b, t, d).astype(np.float32) * 0.5)
    g = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    be = (0.1 * rng.randn(d)).astype(np.float32)
    mkw = lambda: jquantize_int8(jnp.asarray(
        rng.randn(d, d).astype(np.float32) * d ** -0.5))
    mkb = lambda: (0.1 * rng.randn(d)).astype(np.float32)
    wq, bq, wk, wv, bv = mkw(), mkb(), mkw(), mkw(), mkb()
    wo, bo = mkw(), mkb()
    return x, g, be, wq, bq, wk, wv, bv, wo, bo


def _run_k1(case, n_real, h, fuse_o, s8, pv):
    x, g, be, wq, bq, wk, wv, bv, wo, bo = case
    kw = dict(wo=wo, bo=jnp.asarray(bo)) if fuse_o else {}
    ref = np.asarray(jea.encoder_attention_fused_qkv(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(g), jnp.asarray(be), wq,
        jnp.asarray(bq), wk, wv, jnp.asarray(bv), n_real, 0.125, h,
        block_q=128, int8_scores=s8, int8_pv=pv, interpret=True, **kw),
        np.float32)
    t = torch.from_numpy
    kw = dict(wo=_qt(wo), bo=t(bo)) if fuse_o else {}
    got = ea.encoder_attention_fused_qkv(
        t(x).to(torch.bfloat16), t(g), t(be), _qt(wq), t(bq), _qt(wk),
        _qt(wv), t(bv), n_real, 0.125, h, int8_scores=s8, int8_pv=pv, **kw)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    return got, ref


@pytest.mark.parametrize("n_real", [256, 250])
@pytest.mark.parametrize("var", list(INT8))
def test_k1_int8_variants_plain_match_pallas_interpret(var, n_real):
    """K1 quantizes its f32 q projection, before the softmax scale and any
    bf16 rounding, and its bf16 k (encoder_attention.py:443-458)."""
    got, ref = _run_k1(_k1_case(), n_real, 4, False, *INT8[var])
    np.testing.assert_allclose(got[:, :n_real], ref[:, :n_real], **BF16_STEP)


@pytest.mark.parametrize("n_real", [256, 250])
@pytest.mark.parametrize("var", list(ALL))
def test_k1_fused_o_plain_matches_pallas_interpret(var, n_real):
    """x + attention @ wo + bo with the per-pair o-input quantization
    (encoder_attention.py:461-493), alone and with the int8 variants."""
    got, ref = _run_k1(_k1_case(seed=13), n_real, 4, True, *ALL[var])
    _close(got, ref, n_real)


def test_k1_fused_o_many_pairs():
    """Three pairs: the f32 accumulator takes each pair's o row block in
    order (tests/test_encoder_attention.py:266-286)."""
    got, ref = _run_k1(_k1_case(1, 6, 128, 384, seed=15), 128, 6, True,
                       False, False)
    _close(got, ref, 128)


def test_fused_o_is_another_function():
    """The per-pair quantization of the o input is finer than the unfused
    path's per-row one: fused o differs from K1 then x + o projection."""
    x, g, be, wq, bq, wk, wv, bv, wo, bo = _k1_case(seed=13)
    t = torch.from_numpy
    args = (t(x).to(torch.bfloat16), t(g), t(be), _qt(wq), t(bq), _qt(wk),
            _qt(wv), t(bv), 250, 0.125, 4)
    fused = ea.encoder_attention_fused_qkv(*args, wo=_qt(wo), bo=t(bo))
    a = ea.encoder_attention_fused_qkv(*args)
    from nobs_whisper_torch.ops.quant import dense_int8_dynamic
    unfused = (args[0].float() + dense_int8_dynamic(a.float(), _qt(wo), t(bo))
               ).to(torch.bfloat16)
    diff = (fused.float() - unfused.float()).abs()[:, :250]
    assert 0 < diff.max() < 0.1


# ---------------------------------------------------------------------------
# K12 (tests/test_fused_layer.py)
# ---------------------------------------------------------------------------

def _layer_case(b=2, h=4, t=256, d=256, ffn=512, seed=20):
    rng = np.random.RandomState(seed)
    x = _bf16_np(rng.randn(b, t, d).astype(np.float32) * 0.5)
    ln = lambda: ((1.0 + 0.1 * rng.randn(d)).astype(np.float32),
                  (0.1 * rng.randn(d)).astype(np.float32))
    mkw = lambda di, do: jquantize_int8(jnp.asarray(
        rng.randn(di, do).astype(np.float32) * di ** -0.5))
    mkb = lambda n: (0.1 * rng.randn(n)).astype(np.float32)
    ln1_g, ln1_b = ln()
    ln2_g, ln2_b = ln()
    return (x, ln1_g, ln1_b, mkw(d, d), mkb(d), mkw(d, d), mkw(d, d), mkb(d),
            mkw(d, d), mkb(d), ln2_g, ln2_b, mkw(d, ffn), mkb(ffn),
            mkw(ffn, d), mkb(d))


def _torch_layer_args(case):
    t = torch.from_numpy
    return tuple(_qt(z) if isinstance(z, dict) else
                 (t(z).to(torch.bfloat16) if i == 0 else t(z))
                 for i, z in enumerate(case))


def _jax_layer_args(case):
    return [z if isinstance(z, dict) else
            jnp.asarray(z, jnp.bfloat16 if i == 0 else jnp.float32)
            for i, z in enumerate(case)]


# K12 end to end: two int8 requantizations in series. A bf16 step of the
# attention half's output (0.3-10% of its elements, see the module note)
# flips LN2-quantized activations, each of which moves its row of the MLP;
# and under the int8 variants a summation-order flip in the row that holds
# a head's absmax of k or v moves that head's scale, and with it every row
# of the head. Readings over weight seeds 20-23, n_real 250: max 3.9e-2 in
# every variant; mean at most 1.4e-4 without int8 variants, 2.0e-3 with
# them (1.0e-5-1.8e-4 where no head scale moved). Held to KERNEL_TOL and
# these means; the MLP half alone meets KERNEL_MEAN
# (:func:`test_k12_mlp_half_matches_pallas_interpret`).
K12_MEAN = {"none": 2e-4, "i8s": 3e-3, "i8pv": 3e-3, "both": 3e-3}


@pytest.mark.parametrize("var", list(ALL))
def test_k12_plain_matches_pallas_interpret(var):
    """K12 at block_f 256 (two requant chunks of ffn 512), n_real 250."""
    s8, pv = ALL[var]
    case = _layer_case(seed=22 if s8 or pv else 20)
    ref = np.asarray(jfl.encoder_layer_fused(
        *_jax_layer_args(case), 250, 0.125, 4, block_q=128, block_f=256,
        int8_scores=s8, int8_pv=pv, interpret=True), np.float32)
    before = fl.launch_count, dict(fl.variant_launch_count)
    got = fl.encoder_layer_fused(*_torch_layer_args(case), 250, 0.125, 4,
                                 block_f=256, int8_scores=s8, int8_pv=pv)
    assert (fl.launch_count, dict(fl.variant_launch_count)) == before
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - ref)[:, :250]
    assert diff.max() < KERNEL_TOL, diff.max()
    assert diff.mean() < K12_MEAN[var], diff.mean()


@pytest.mark.parametrize("var", list(ALL))
def test_k12_mlp_half_matches_pallas_interpret(var):
    """The Pallas K12 is its fused-o kernel then its resident MLP, bit for
    bit (tests/test_fused_layer.py); given the Pallas fused-o output, the
    port's MLP half (K2's plain version at K12's block_f) is the Pallas
    K12's within KERNEL_TOL and KERNEL_MEAN. Readings over seeds 20-23:
    max 1.8e-2, mean at most 1.1e-5."""
    s8, pv = ALL[var]
    case = _layer_case(seed=22 if s8 or pv else 20)
    j = _jax_layer_args(case)
    ref = np.asarray(jfl.encoder_layer_fused(
        *j, 250, 0.125, 4, block_q=128, block_f=256, int8_scores=s8,
        int8_pv=pv, interpret=True), np.float32)
    x2 = jea.encoder_attention_fused_qkv(
        *j[:8], 250, 0.125, 4, block_q=128, wo=j[8], bo=j[9],
        int8_scores=s8, int8_pv=pv, interpret=True)
    t = _torch_layer_args(case)
    got = fm.encoder_mlp_int8_resident(
        torch.from_numpy(np.asarray(x2, np.float32)).to(
            torch.bfloat16).reshape(-1, 256), *t[10:], block_f=256)
    _close(got.float().numpy().reshape(ref.shape), ref, 250)


@pytest.mark.parametrize("var", list(ALL))
def test_k12_plain_is_fused_o_then_k2(var):
    """K12's plain version is plain K1 with fused o, then plain K2 at the
    same block_f, bit for bit (tests/test_fused_layer.py:48-61 pins the
    Pallas kernels the same way)."""
    s8, pv = ALL[var]
    args = _torch_layer_args(_layer_case(seed=21))
    (x, g1, b1n, wq, bq, wk, wv, bv, wo, bo, g2, b2n, fc1, fc1_b, fc2,
     fc2_b) = args
    got = fl.encoder_layer_fused_plain(*args, 250, 0.125, 4, block_f=256,
                                       int8_scores=s8, int8_pv=pv)
    x2 = ea.encoder_attention_fused_qkv_plain(
        x, g1, b1n, wq, bq, wk, wv, bv, 250, 0.125, 4, s8, pv, wo, bo)
    b, t, d = x.shape
    want = fm.encoder_mlp_int8_resident_plain(
        x2.reshape(b * t, d), g2, b2n, fc1, fc1_b, fc2, fc2_b, block_f=256)
    torch.testing.assert_close(got, want.reshape(b, t, d), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# K12's gate at large-v3-turbo's width
# ---------------------------------------------------------------------------

def _turbo_gates(monkeypatch, knobs, quantized=True):
    """The gates of a large-v3-turbo encoder (d 1280, 20 heads of 64, ffn
    5120), its weights on the meta device (the gates read types only)."""
    for k in ("NWT_ATTN_FUSED", "NWT_MLP_BF", "NWT_MLP_CHUNKED",
              "NWT_NO_INT8_MLP", "NWT_ATTN_I8", "NWT_ATTN_I8PV",
              "NWT_NO_FLASH", "NWT_ATTN_BHTD", "NWT_INT8_QKV",
              "NWT_LIB_FLASH"):
        monkeypatch.delenv(k, raising=False)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg = WhisperConfig(name="large-v3-turbo", n_mels=128, n_vocab=51866,
                        n_audio_ctx=1500, n_audio_state=1280,
                        n_audio_head=20, n_audio_layer=32, n_text_ctx=448,
                        n_text_state=1280, n_text_head=20, n_text_layer=4)
    w = lambda *s: (quantize_int8(torch.zeros(*s, device="meta"))
                    if quantized else torch.zeros(*s, device="meta"))
    blocks = {"q_w": w(1280, 1280), "o_w": w(1280, 1280),
              "fc1_w": w(1280, 5120), "fc2_w": w(5120, 1280)}
    return tw.encoder_kernel_gates(cfg, blocks, torch.bfloat16)


@pytest.mark.parametrize("knobs,attention,o,mlp,block_f", [
    ({"NWT_ATTN_FUSED": "3"}, "K12", "K12", "K12", 1280),
    ({"NWT_ATTN_FUSED": "3", "NWT_MLP_CHUNKED": "1"}, "K12", "K12", "K12",
     1280),
    ({"NWT_ATTN_FUSED": "3", "NWT_MLP_BF": "640"}, "K12", "K12", "K12", 640),
    ({"NWT_ATTN_FUSED": "2"}, "K1", "K1", "K2", 2560),
    ({"NWT_ATTN_FUSED": "3", "NWT_NO_INT8_MLP": "1"}, "K1", "K1", None,
     2560),
    ({}, "K1", None, "K2", 2560),
])
def test_k12_gate_and_chunk_at_turbo_width(monkeypatch, knobs, attention, o,
                                           mlp, block_f):
    """K12's fc2-input chunk is ``NWT_MLP_BF`` or 1280 (whisper.py:410),
    whatever ``NWT_MLP_CHUNKED`` says; K2's is 2560. At turbo's ffn of 5120
    the two are different functions (the tiny models' ffn of 512 resolves
    both to 512), and K12's resolves to itself."""
    g = _turbo_gates(monkeypatch, knobs)
    assert (g.attention, g.o, g.mlp, g.block_f) == (attention, o, mlp,
                                                    block_f)
    assert fm.resolve_block_f(g.block_f, 5120) == block_f
    g = _turbo_gates(monkeypatch, dict(knobs, NWT_ATTN_I8="1",
                                       NWT_ATTN_I8PV="1"))
    assert (g.attention, g.o, g.int8_scores, g.int8_pv) == (attention, o,
                                                            True, True)
    # a float encoder takes K3 under every one of these knobs
    assert _turbo_gates(monkeypatch, knobs, quantized=False).attention == "K3"


def test_k12_chunk_reaches_the_kernel(monkeypatch):
    """The encoder hands K12 the gate's chunk: a one-layer encoder at
    turbo's width (d 1280, 20 heads, ffn 5120, 16 audio frames) with
    ``NWT_ATTN_FUSED=3`` and ``NWT_MLP_CHUNKED``."""
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    for k, v in (("NWT_ATTN_FUSED", "3"), ("NWT_MLP_CHUNKED", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("NWT_MLP_BF", raising=False)
    cfg = tiny_test_config(d=1280, heads=20, n_audio_ctx=16, enc_layers=1,
                           dec_layers=1, n_text_ctx=8)
    params = tw.init_params(0, cfg, dtype=torch.bfloat16)
    enc = quantize_encoder_params({"encoder": params["encoder"]})
    seen = []
    real = fl.encoder_layer_fused_plain

    def spy(*a, **k):
        bf = inspect.signature(real).bind(*a, **k).arguments["block_f"]
        seen.append((bf, fm.resolve_block_f(bf, 5120)))
        return real(*a, **k)
    monkeypatch.setattr(fl, "encoder_layer_fused_plain", spy)
    mel = torch.from_numpy(np.random.RandomState(0).randn(
        1, cfg.n_mels, 32).astype(np.float32))
    out = tw.encode(enc, mel, cfg, compute_dtype=torch.bfloat16)
    assert seen == [(1280, 1280)]
    assert torch.isfinite(out.float()).all()


def test_variant_kernel_wrappers_do_not_fall_back_off_cpu():
    """Only a CPU tensor takes a plain version: any other device goes to
    the kernel path (and here, with no card, raises)."""
    d, meta = 128, "meta"
    qt = lambda *s: {k: v.to(meta) for k, v in quantize_int8(
        torch.randn(*s)).items()}
    w, w1, w2 = qt(d, d), qt(d, 4 * d), qt(4 * d, d)
    x = torch.zeros(1, 64, d, device=meta, dtype=torch.bfloat16)
    v, v4 = torch.zeros(d, device=meta), torch.zeros(4 * d, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ea.encoder_attention_fused_qkv(x, v, v, w, v, w, w, v, 64, 0.125, 2,
                                       int8_scores=True, wo=w, bo=v)
    with pytest.raises(ValueError, match="unsupported device"):
        ea.encoder_attention_btd(x, x, x, 64, 0.125, 2, int8_pv=True)
    with pytest.raises(ValueError, match="unsupported device"):
        fl.encoder_layer_fused(x, v, v, w, v, w, w, v, w, v, v, v, w1, v4,
                               w2, v, 64, 0.125, 2)


def test_amax_parts_matches_the_kernel():
    """The int8 variants' workspace holds ``AMAX_PARTS`` partial absmax
    per (batch row, head), the count ``csrc/encoder_attention.cu``'s
    ``int8_prep`` writes and ``head_scale`` reads."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(ea.__file__), os.pardir, "csrc",
                            "encoder_attention.cu")).read()
    assert re.findall(r"constexpr int AMAX_PARTS = (\d+);", src) == [
        str(ea.AMAX_PARTS)]
    ws = ea._i8_workspace(2, 64, 128, 2, True, True, torch.device("cpu"))
    assert tuple(ws[-1].shape) == (2, 2, 2, ea.AMAX_PARTS)
