"""The decode-step kernels on the CPU: K4 (``cross_attention_decode_bf16``),
K5 (``cross_attention_decode_q8``) and K6 (``q8_matmul``), the int8
cross-KV layout, their gates, and the window program that takes them,
against the JAX package.

The port's wrappers run the plain versions for CPU tensors; on the card
they launch the CUDA kernels (tests/test_torch_kernels_gpu.py). Inputs are
made with numpy from a seed and cross as numpy arrays.

Tolerances, each with its reason:

* K4 and K5: the plain versions repeat the Pallas kernels' rounding points
  (bf16 q, f32 scores, the row normalised before its bf16 cast, f32
  accumulation); what is left is f32 summation order, which can flip one
  bf16 probability by one step: held to one bf16 step elementwise (rtol
  2^-7, atol 2^-9), under the JAX tests' 0.02 ceiling
  (tests/test_attention_pallas.py:59,86).
* K6: the products are exact in f32 and only their summation order
  differs: 1e-5 absolute plus 1e-5 relative on outputs of order 1
  (readings: at most 2e-6).
* The int8 cross-KV: quantized values equal, scales to 1e-6 relative
  (tests/test_attention_pallas.py:160-186).
* The XLA reference functions, all f32: 1e-5.
"""

import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_slice as ts
from nobs_whisper_tpu.ops import attention_pallas as jap
from nobs_whisper_tpu.ops import quant as jq
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import attention_pallas as tap
from nobs_whisper_torch.ops import quant as tq
from nobs_whisper_torch.utils.testing import KernelSpies

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
K6_TOL = dict(rtol=1e-5, atol=1e-5)
KNOBS = ("NWT_XATTN_KERNEL", "NWT_Q8_KV_PALLAS", "NWT_Q8_KERNEL_MIN_BYTES")
LAYOUT_KNOBS = ("NWT_NO_KT_XATTN", "NWT_FORCE_KT", "NWT_XATTN_BF16")
DECODE = ("K4", "K5", "K6")


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for k in KNOBS + LAYOUT_KNOBS:
        monkeypatch.delenv(k, raising=False)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _tb(a):
    return _t(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(
        torch.bfloat16)


def _qkv(b, h, t, dh, seed):
    """tests/test_attention_pallas.py::_make: q (B, H, 1, Dh), K and V
    (1, B, H, T, Dh) f32."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, 1, dh).astype(np.float32) * 0.5
    k = rng.randn(1, b, h, t, dh).astype(np.float32)
    v = rng.randn(1, b, h, t, dh).astype(np.float32)
    return q, k, v


def _first(tree):
    return jax.tree.map(lambda z: z[0], tree)


def _qkv_torch(tree):
    """A reference q8 dict as torch tensors (int8 q, f32 s)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


CASES = [(2, 4, 300, 300, 0),      # Tp = 384
         (2, 4, 300, 40, 1),       # t_real inside the first 128 tile
         (1, 2, 40, 40, 2)]        # one tile, B = 1


# ---------------------------------------------------------------------------
# K4, K5 and K6 against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,t,t_real,seed", CASES)
def test_k4_plain_matches_pallas_interpret(b, h, t, t_real, seed):
    q, k, v = _qkv(b, h, t, 64, seed)
    kd, vd = jap.pack_cross_kv_bf16((jnp.asarray(k), jnp.asarray(v)))
    packed = {"kT": kd["kT"][0], "v": vd["v"][0]}
    ref = np.asarray(jap.cross_attention_decode_bf16(
        jnp.asarray(q), packed, t_real, interpret=True))
    tp = {"kT": _tb(packed["kT"]), "v": _tb(packed["v"])}
    got = tap.cross_attention_decode_bf16(torch.from_numpy(q), tp, t_real)
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, 64)
    np.testing.assert_allclose(got.numpy(), ref, **BF16_STEP)


@pytest.mark.parametrize("b,h,t,seed", [(2, 4, 300, 3), (1, 2, 40, 4)])
def test_k5_plain_matches_pallas_interpret(b, h, t, seed):
    """Tp = 384 with 84 zero-scale positions, and T = 40 inside one tile."""
    q, k, v = _qkv(b, h, t, 64, seed)
    kq, vq = jap.quantize_cross_kv((jnp.asarray(k), jnp.asarray(v)))
    ref = np.asarray(jap.cross_attention_decode_q8(
        jnp.asarray(q), _first(kq), _first(vq), interpret=True))
    got = tap.cross_attention_decode_q8(
        torch.from_numpy(q), _qkv_torch(_first(kq)), _qkv_torch(_first(vq)))
    assert got.dtype == torch.float32 and got.shape == (b, h, 1, 64)
    np.testing.assert_allclose(got.numpy(), ref, **BF16_STEP)


def _k6_case(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = jq.quantize_int8(jnp.asarray(
        rng.randn(k, n).astype(np.float32) * k ** -0.5))
    return x, w


@pytest.mark.parametrize("x_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("n", [256, 1000])          # 1000: a ragged tile
# 17 and 65: one row past the CUDA kernel's tiles (16 decode rows, 64-row
# prefill tiles)
@pytest.mark.parametrize("m", [1, 8, 17, 64, 65, 256])
def test_k6_plain_matches_pallas_interpret(m, n, x_dtype):
    """K = 320 (not a multiple of 64). At M = 1 XLA:CPU fuses the kernel's
    bf16 weight product into its matrix-vector product and skips that
    rounding (the interpret-mode output at M = 1 sits up to one bf16 step
    of each weight away from every rounding of the TPU kernel), so the
    row is held to the same kernel run on eight rows, where the rounding
    happens; the M = 1 output is held within one bf16 step of each weight
    (2^-8 of sum |x w|)."""
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[x_dtype]
    x, w = _k6_case(m, 320, n, seed=m + n)
    xj = jnp.asarray(x, jdt)
    rows = jnp.concatenate([xj, jnp.zeros((7, 320), jdt)]) if m == 1 else xj
    ref = np.asarray(jq.q8_matmul(rows, w, interpret=True))[:m]
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(tdt)
    got = tq.q8_matmul(xt, _qkv_torch(w))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), ref, **K6_TOL)
    if m == 1:
        direct = np.asarray(jq.q8_matmul(xj, w, interpret=True))
        w32 = np.asarray(jq.dequantize_int8(w), np.float64)
        bound = 2.0 ** -8 * (np.abs(np.asarray(xt.float())) @ np.abs(w32))
        assert (np.abs(direct - got.numpy()) <= bound + 1e-6).all()


def test_k6_decode_rows_match_the_kernel():
    """``K6_DECODE_ROWS``, by which the wrapper counts the decode kernel's
    launches, is the M above which ``csrc/q8_matmul.cu`` launches its
    prefill kernel (``DECODE_ROWS``)."""
    import re
    src = open(os.path.join(os.path.dirname(tq.__file__), os.pardir, "csrc",
                            "q8_matmul.cu")).read()
    assert re.findall(r"constexpr int DECODE_ROWS = (\d+);", src) == [
        str(tq.K6_DECODE_ROWS)]
    assert "if (M > DECODE_ROWS)" in src


def test_dense_and_dequantize_match_reference():
    """``quant.dense`` on a plain weight, on the dequant path and on K6
    (whose reference, ``dense(use_kernel=True)``, runs the Pallas kernel
    outside interpret mode: a TPU only; its function is the kernel's in
    x.dtype), and ``dequantize_int8``."""
    x, w = _k6_case(8, 128, 96, seed=5)
    tw8, xt = _qkv_torch(w), torch.from_numpy(x)
    np.testing.assert_array_equal(
        tq.dequantize_int8(tw8).numpy(), np.asarray(jq.dequantize_int8(w)))
    plain = np.asarray(jq.dequantize_int8(w))
    np.testing.assert_allclose(
        tq.dense(xt, torch.from_numpy(np.array(plain))).numpy(),
        np.asarray(jq.dense(jnp.asarray(x), jnp.asarray(plain))), **K6_TOL)
    np.testing.assert_allclose(tq.dense(xt, tw8).numpy(),
                               np.asarray(jq.dense(jnp.asarray(x), w)),
                               **K6_TOL)
    got = tq.dense(xt, tw8, use_kernel=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jq.q8_matmul(jnp.asarray(x), w,
                                             interpret=True)), **K6_TOL)


# ---------------------------------------------------------------------------
# the int8 cross-KV layout and the reference functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [300, 40, 128])
def test_quantize_cross_kv_matches_reference(t):
    _, k, v = _qkv(2, 4, t, 64, seed=t)
    k[0, 1, 2, 5] = 0.0                     # an all-zero row: the 1e-12 floor
    ref_k, ref_v = jap.quantize_cross_kv((jnp.asarray(k), jnp.asarray(v)))
    got_k, got_v = tap.quantize_cross_kv((torch.from_numpy(k),
                                          torch.from_numpy(v)))
    tp = -(-t // 128) * 128
    assert tuple(got_k["q"].shape) == (1, 2, 4, 64, tp)
    assert tuple(got_v["q"].shape) == (1, 2, 4, tp, 64)
    assert got_k["q"].is_contiguous()
    for ref, got in ((ref_k, got_k), (ref_v, got_v)):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(ref["s"]),
                                   rtol=1e-6)
        assert (got["s"][..., t:] == 0).all() and (got["s"][..., :t] > 0).all()
    q, s = tap.quant_kv_padded(torch.from_numpy(k))
    rq, rs = jap.quant_kv_padded(jnp.asarray(k))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)


def test_precompute_cross_kv_q8_matches_reference():
    """The per-layer projection and quantization against the reference's
    on the same weights and encoder states (f32), and against the port's
    own quantize_cross_kv(precompute_cross_kv(...)) exactly."""
    from nobs_whisper_tpu.models import whisper as jw
    from nobs_whisper_tpu.utils.testing import tiny_test_config
    cfg = tiny_test_config()
    jp = jw.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = tw.params_from_jax(jax.tree.map(np.asarray, jp))
    xa = np.random.RandomState(1).randn(
        2, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32)
    ref_k, ref_v = jw.precompute_cross_kv_q8(jp, jnp.asarray(xa), cfg)
    got_k, got_v = tw.precompute_cross_kv_q8(tp, torch.from_numpy(xa), cfg)
    for ref, got in ((ref_k, got_k), (ref_v, got_v)):
        np.testing.assert_array_equal(got["q"].numpy(), np.asarray(ref["q"]))
        np.testing.assert_allclose(got["s"].numpy(), np.asarray(ref["s"]),
                                   rtol=1e-6)
    un_k, un_v = tap.quantize_cross_kv(
        tw.precompute_cross_kv(tp, torch.from_numpy(xa), cfg))
    for a, b in ((got_k, un_k), (got_v, un_v)):
        assert all(torch.equal(a[z], b[z]) for z in ("q", "s"))


@pytest.mark.parametrize("s", [1, 5])
def test_reference_functions_match(s):
    """cross_attention_dequant_reference (the q8 default, and its path for
    S > 1) and cross_attention_bf16_reference against the reference's."""
    rng = np.random.RandomState(s)
    q = rng.randn(2, 4, s, 64).astype(np.float32) * 0.5
    _, k, v = _qkv(2, 4, 300, 64, seed=8)
    kq, vq = jap.quantize_cross_kv((jnp.asarray(k), jnp.asarray(v)))
    ref = np.asarray(jap.cross_attention_dequant_reference(
        jnp.asarray(q), _first(kq), _first(vq)))
    got = tap.cross_attention_dequant_reference(
        torch.from_numpy(q), _qkv_torch(_first(kq)), _qkv_torch(_first(vq)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    kd, vd = jap.pack_cross_kv_bf16((jnp.asarray(k), jnp.asarray(v)))
    packed = {"kT": kd["kT"][0], "v": vd["v"][0]}
    ref = np.asarray(jap.cross_attention_bf16_reference(
        jnp.asarray(q), packed, 300))
    got = tap.cross_attention_bf16_reference(
        torch.from_numpy(q), {"kT": _tb(packed["kT"]),
                              "v": _tb(packed["v"])}, 300)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the slice: the window program with the decode kernels, against the
# reference with its kernels routed to interpret mode
# ---------------------------------------------------------------------------

def route_reference_kernels(monkeypatch):
    """The reference takes K4, K5 and K6 on a TPU only
    (``jax.default_backend() == "tpu"``, whisper.py:718, :801, :814).
    Route them here to the Pallas kernels in interpret mode under the
    reference's own conditions, and pass everything else through
    unchanged: ``cross_and_mlp`` imports the two attention functions at
    each call (whisper.py:787-789, :812-813) and calls the module global
    ``_dense``. The kernels run compiled (interpret mode compiles the
    kernel body even under ``jax.disable_jit``; compiling the whole call
    caches it by shape), the rest of the reference as the caller runs it.
    Returns the count of each routed kernel call."""
    from nobs_whisper_tpu.models import whisper as jw
    real_dense = jw._dense
    real_kt = jap.cross_attention_kt_xla
    real_dq = jap.cross_attention_dequant_reference
    calls = dict.fromkeys(DECODE, 0)

    def compiled(fn, *static):
        jitted = jax.jit(functools.partial(fn, interpret=True),
                         static_argnums=static)

        def run(*args):
            with jax.disable_jit(False):
                return jitted(*args)
        return run

    k6 = compiled(jq.q8_matmul)
    k4 = compiled(jap.cross_attention_decode_bf16, 2)
    k5 = compiled(jap.cross_attention_decode_q8)

    def dense(x, w, b=None):
        if jq.is_quantized(w):
            lead = x.shape[:-1]
            m = int(np.prod(lead)) if lead else 1
            threshold = int(os.environ.get("NWT_Q8_KERNEL_MIN_BYTES", 0)
                            or (1 << 62))
            if m <= 256 and int(np.prod(w["q"].shape[-2:])) >= threshold:
                calls["K6"] += 1
                y = k6(x.reshape(-1, x.shape[-1]), w)
                y = y.reshape(*lead, -1).astype(x.dtype)
                return y if b is None else y + b
        return real_dense(x, w, b)

    def kt_xla(q, packed, t_real):
        if os.environ.get("NWT_XATTN_KERNEL") and q.shape[-2] == 1:
            calls["K4"] += 1
            return k4(q, packed, t_real)
        return real_kt(q, packed, t_real)

    def dequant(q, kq, vq):
        if os.environ.get("NWT_Q8_KV_PALLAS") and q.shape[-2] == 1:
            calls["K5"] += 1
            return k5(q, kq, vq)
        return real_dq(q, kq, vq)

    monkeypatch.setattr(jw, "_dense", dense)
    monkeypatch.setattr(jap, "cross_attention_kt_xla", kt_xla)
    monkeypatch.setattr(jap, "cross_attention_dequant_reference", dequant)
    return calls


MODES = {"q8": dict(q8_kv=True, xattn_bf16=False),
         "packed": dict(q8_kv=False, xattn_bf16=True)}
# Weight seeds of the bf16 cases. Over seeds 0-9 (``PYTHONPATH=. python
# tests/torch_bf16_seed_sweep.py 10 decode``, three windows a seed), int8
# cross-KV gives equal greedy tokens in every window on seeds 2 and 4-9
# and differs in one window on 0, 1 and 3; the packed layout on 0 and 2-9,
# differing in one window on 1: the bf16 near-ties of a random tiny model
# that test_torch_slice.py describes. Seed 7 agrees in both.
BF16_SEEDS = {"q8": 7, "packed": 7}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["q8", "packed"])
def test_decode_kernel_slice_matches_reference(monkeypatch, mode, dtype):
    """The int8 window program (K1/K2 encoder at bf16, K2 at f32) with the
    three decode knobs on, int8 cross-KV (K5, K6) or the packed bf16
    layout (K4, K6), against the reference run op by op
    (``jax.disable_jit``) with the same kernels in interpret mode. The
    port takes each kernel as often as its gates predict for the forwards
    it ran, and the reference takes the same kernels (it runs one forward
    more at the end of its loop, whose logits it does not use); greedy
    tokens are equal (at bf16 on the weight seeds above), and the scores
    agree to 1e-3 relative (summation order; see test_torch_slice.py)."""
    for k in KNOBS:
        monkeypatch.setenv(k, "1")
    if dtype == "f32":
        monkeypatch.setenv("NWT_NO_FLASH", "1")   # the TPU's f32 gates
    ref_calls = route_reference_kernels(monkeypatch)
    spies = KernelSpies(monkeypatch.setattr, kernels=DECODE)
    seed = BF16_SEEDS[mode] if dtype == "bf16" else 7
    tw.decoder_forward_calls.clear()
    with jax.disable_jit():
        got, ref = ts._window_slice(dtype, seed=seed, **MODES[mode])
    n_layer = 2                     # the slice's tiny_test_config
    want = predicted_launches(tw.decoder_forward_calls, n_layer)
    # the cross-KV projection of 3 windows x 32 positions has under 256
    # rows here, so K6 takes its two weights a layer as well
    want["K6"] += 2 * n_layer
    assert spies.calls == want
    for calls in (spies.calls, ref_calls):
        assert calls["K6"] > 0
        assert (calls["K5"] > 0) == (mode == "q8")
        assert (calls["K4"] > 0) == (mode == "packed")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _int8_decoder(n_audio_ctx=96, seed=3):
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=n_audio_ctx,
                           n_text_ctx=64)
    return cfg, quantize_decoder_params(tw.init_params(seed, cfg))


def _run_window(cfg, params, b=3, mode="q8", sample_len=6):
    """The port's decode loop alone on random encoder states (B x 96
    positions: the cross-KV projection has more than 256 rows, as at full
    size, so K6 is not taken there)."""
    from nobs_whisper_torch.decode import greedy as tg
    from nobs_whisper_torch.decode import rules as trl
    xa = torch.from_numpy(np.random.RandomState(2).randn(
        b, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    prompts = [[cfg.sot, cfg.lang_base, cfg.transcribe]] * b
    ptok, pad = tg.pad_prompts(prompts, cfg.eot)
    tw.decoder_forward_calls.clear()
    return tg.decode_window_impl(
        params, xa, torch.from_numpy(ptok).long(),
        torch.from_numpy(pad).long(), torch.zeros(b, dtype=torch.long),
        trl.build_rule_tables(cfg, trl.DecodeOptions()), torch.zeros(b),
        None, cfg, sample_len, sampling=False, **MODES[mode])


def predicted_launches(calls, n_layer):
    """K4, K5 and K6 launches the gates predict for the decoder forwards
    in ``calls`` (``models/whisper.py::decoder_forward_calls``): K4 or K5
    once a layer in a single-token forward on the packed or int8 cross-KV;
    K6 on the 8 int8 weights of each layer and the logit projection in a
    forward of at most 256 rows (the knobs at 1 byte)."""
    n = lambda pred: sum(c for key, c in calls.items() if pred(*key))
    return {"K4": n_layer * n(lambda lay, b, s: lay == "packed" and s == 1),
            "K5": n_layer * n(lambda lay, b, s: lay == "q8" and s == 1),
            "K6": (8 * n_layer + 1) * n(lambda lay, b, s: b * s <= 256)}


@pytest.mark.parametrize("mode", ["q8", "packed"])
def test_no_decode_kernel_without_knobs(monkeypatch, mode):
    cfg, params = _int8_decoder()
    spies = KernelSpies(monkeypatch.setattr, kernels=DECODE)
    _run_window(cfg, params, mode=mode)
    assert sum(tw.decoder_forward_calls.values()) > 1
    assert spies.calls == {"K4": 0, "K5": 0, "K6": 0}


@pytest.mark.parametrize("mode", ["q8", "packed"])
def test_decode_kernel_counts_follow_gates(monkeypatch, mode):
    for k in KNOBS:
        monkeypatch.setenv(k, "1")
    cfg, params = _int8_decoder()
    spies = KernelSpies(monkeypatch.setattr, kernels=DECODE)
    _run_window(cfg, params, mode=mode)
    calls = dict(tw.decoder_forward_calls)
    assert set(calls) == {(mode, 3, 8), (mode, 3, 1)}
    want = predicted_launches(calls, cfg.n_text_layer)
    assert spies.calls == want
    assert want["K4" if mode == "packed" else "K5"] > 0


def test_k6_threshold_is_a_byte_count(monkeypatch):
    """NWT_Q8_KERNEL_MIN_BYTES above the (128, 128) weights but below the
    (128, 512) MLP weights and the (128, 1000) logit projection: K6 on
    fc1, fc2 and the logits only."""
    monkeypatch.setenv("NWT_Q8_KERNEL_MIN_BYTES", str(128 * 128 + 1))
    cfg, params = _int8_decoder()
    spies = KernelSpies(monkeypatch.setattr, kernels=DECODE)
    _run_window(cfg, params)
    forwards = sum(tw.decoder_forward_calls.values())
    assert spies.calls == {"K4": 0, "K5": 0,
                           "K6": (2 * cfg.n_text_layer + 1) * forwards}


BIG = 1 << 62
PROJ, LOGITS = 1280 * 1280, 1280 * 51866


@pytest.mark.parametrize("device,dtype,m,nbytes,plain,knob,route", [
    # the knob unset: K6 on the card at bf16 compute, up to 256 rows
    ("cuda", torch.bfloat16, 32, PROJ, False, None, "K6"),
    ("cuda", torch.bfloat16, 1, PROJ, False, None, "K6"),
    ("cuda", torch.bfloat16, 256, PROJ, False, None, "K6"),
    ("cuda", torch.bfloat16, 32, LOGITS, False, None, "K6"),  # the logits
    ("cpu", torch.bfloat16, 32, PROJ, False, None, "dequant"),
    ("cpu", torch.float32, 32, PROJ, False, None, "dequant"),
    ("cuda", torch.float32, 32, PROJ, False, None, "dequant"),
    ("cuda", torch.float32, 32, LOGITS, False, None, "dequant"),
    ("cuda", torch.bfloat16, 32, PROJ, True, None, "dequant"),  # tp shard
    ("cuda", torch.bfloat16, 257, PROJ, False, None, "dequant"),
    ("cuda", torch.bfloat16, 3000, PROJ, False, None, "dequant"),  # cross-KV
    # the knob set: the reference's gate on any device and dtype
    ("cpu", torch.float32, 8, PROJ, False, 1, "K6"),
    ("cuda", torch.float32, 8, LOGITS, False, 1, "K6"),
    ("cuda", torch.bfloat16, 8, PROJ, False, PROJ, "K6"),
    ("cuda", torch.bfloat16, 8, PROJ, False, PROJ + 1, "dequant"),
    ("cuda", torch.bfloat16, 8, LOGITS, False, BIG, "dequant"),
    ("cuda", torch.bfloat16, 8, PROJ, True, 1, "dequant"),
    ("cpu", torch.float32, 257, PROJ, False, 1, "dequant"),
])
def test_q8_route_gate(device, dtype, m, nbytes, plain, knob, route):
    """``models/whisper.py::q8_route`` as a pure function: (device, compute
    dtype, rows, weight bytes, kernels off, knob) -> route."""
    assert tw.q8_route(device, dtype, m, nbytes, plain, knob) == route


@pytest.mark.parametrize("value,want", [(None, None), ("", None),
                                        ("0", None), ("4096", 4096)])
def test_q8_kernel_min_bytes_reads_the_knob(monkeypatch, value, want):
    if value is not None:
        monkeypatch.setenv("NWT_Q8_KERNEL_MIN_BYTES", value)
    assert tw.q8_kernel_min_bytes() == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_logits_route_at_the_compute_dtype(monkeypatch, dtype):
    """The logit projection asks the gate with x at the compute dtype,
    before its f32 cast, and returns f32 logits; on the CPU every route is
    the dequant path, whose logits are today's: f32 x times the f32
    dequantized embedding, bit for bit."""
    from nobs_whisper_torch.ops.quant import quantize_decoder_params
    cfg, _ = _int8_decoder(n_audio_ctx=32)
    params = quantize_decoder_params(tw.init_params(3, cfg, dtype))
    asked = []
    real = tw.q8_route
    monkeypatch.setattr(tw, "q8_route", lambda *a: asked.append(a) or real(*a))
    b = 2
    xa = torch.from_numpy(np.random.RandomState(4).randn(
        b, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    cross = tw.precompute_cross_kv(params, xa.to(dtype), cfg)
    cache = tw.init_kv_cache(cfg, b, dtype=dtype, t_ctx=16)
    tokens = torch.full((b, 1), cfg.sot, dtype=torch.long)
    logits, _ = tw.decoder_forward(params, tokens, 0,
                                   torch.zeros(b, dtype=torch.long), cache,
                                   cross, cfg, dtype)
    head = [a for a in asked if a[3] == cfg.n_text_state * cfg.n_vocab]
    assert [(a[0], a[1], a[2]) for a in head] == [("cpu", dtype, b)]
    assert all(a[1] == dtype for a in asked)
    assert logits.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("plain", [False, True])
def test_the_dequant_route_keeps_its_bits(monkeypatch, dtype, plain):
    """With the knob unset the CPU, and a plain shard with the knob set,
    run the dequant path as before: x @ (q * s) in the compute dtype, then
    the bias; the logits' f32 product on bf16 x likewise."""
    from nobs_whisper_torch.parallel import tp as ttp
    if plain:
        monkeypatch.setenv("NWT_Q8_KERNEL_MIN_BYTES", "1")
    rng = np.random.RandomState(9)
    w = tq.quantize_int8(torch.from_numpy(rng.randn(64, 96).astype(
        np.float32)))
    x = torch.from_numpy(rng.randn(2, 3, 64).astype(np.float32)).to(dtype)
    bias = torch.from_numpy(rng.randn(96).astype(np.float32)).to(dtype)
    with ttp.plain_ops() if plain else contextlib.nullcontext():
        got = tw._dense(x, w, bias)
        logits = tw._q8_linear(x, w, None, torch.float32)
    want = x @ (w["q"].to(dtype) * w["s"].to(dtype)) + bias
    assert torch.equal(got, want)
    assert torch.equal(logits, x.float() @ (w["q"].float() * w["s"].float()))


@pytest.mark.parametrize("knob,route", [(None, "dequant"), ("1", "K6")])
def test_the_batch_record_counts_the_step_routes(monkeypatch, knob, route):
    """A batch record counts each decode step's int8 linears and the
    logits by route (8 a layer and one a forward); the prefill and the
    cross-KV projection are not decode steps."""
    from nobs_whisper_torch.utils.profiling import Profiler
    if knob:
        monkeypatch.setenv("NWT_Q8_KERNEL_MIN_BYTES", knob)
    cfg, params = _int8_decoder()
    prof = Profiler()
    with prof.batch([(0, 0)] * 3) as rec:
        _run_window(cfg, params, mode="packed")
    steps = sum(c for (_, _, s), c in tw.decoder_forward_calls.items()
                if s == 1)
    assert steps > 0
    assert rec.q8_linears == {route: (8 * cfg.n_text_layer + 1) * steps}
    summary = prof.batch_summary()["q8_linears"]
    assert summary["k6_share"] == (route == "K6")


@pytest.mark.parametrize("b,s,mode", [(9, 32, "q8"), (2, 8, "q8"),
                                      (2, 8, "packed"), (1, 1, "packed")])
def test_kernel_gates_by_rows_and_tokens(monkeypatch, b, s, mode):
    """One decoder forward with the knobs on: more than 256 rows (a 9 x 32
    prefill) takes no K6; more than one token takes neither K4 nor K5."""
    from nobs_whisper_torch.models.whisper import init_kv_cache
    for k in KNOBS:
        monkeypatch.setenv(k, "1")
    cfg, params = _int8_decoder(n_audio_ctx=32)
    xa = torch.from_numpy(np.random.RandomState(4).randn(
        b, cfg.n_audio_ctx, cfg.n_audio_state).astype(np.float32))
    xk, xv = tw.precompute_cross_kv(params, xa, cfg)
    cross = (tap.quantize_cross_kv((xk, xv)) if mode == "q8"
             else tap.pack_cross_kv_bf16((xk, xv)))
    tokens = torch.full((b, s), cfg.sot, dtype=torch.long)
    cache = init_kv_cache(cfg, b, t_ctx=40)
    spies = KernelSpies(monkeypatch.setattr, kernels=DECODE)
    tw.decoder_forward_calls.clear()
    logits, _ = tw.decoder_forward(params, tokens, 0,
                                   torch.zeros(b, dtype=torch.long), cache,
                                   cross, cfg)
    assert logits.shape == (b, s, cfg.n_vocab)
    assert bool(torch.isfinite(logits).all())
    assert spies.calls == predicted_launches(tw.decoder_forward_calls,
                                             cfg.n_text_layer)
    assert (spies.calls["K6"] > 0) == (b * s <= 256)
    assert spies.calls["K4"] + spies.calls["K5"] == (
        cfg.n_text_layer if s == 1 else 0)


# ---------------------------------------------------------------------------
# serving with int8 cross-KV, and the packed-layout knobs
# ---------------------------------------------------------------------------

def test_batched_engine_q8_cross_kv_serves_on_cpu(tmp_path):
    """``BatchedEngine(eng, opts=DecodeOptions(q8_cross_kv=True))`` on the
    CPU, concurrent fixed-language and auto-language requests, against the
    reference's BatchedEngine with the same options: greedy tokens,
    text and language equal."""
    import threading
    from nobs_whisper_tpu.api import WhisperEngine as JaxEngine
    from nobs_whisper_tpu.decode import rules as jr
    from nobs_whisper_tpu.pipeline.batched_engine import \
        BatchedEngine as JaxBatchedEngine
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.decode import rules as trl
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    from nobs_whisper_torch.utils.testing import (speech_like_audio,
                                                  write_tiny_checkpoint)
    path = str(tmp_path / "tiny.bin")
    write_tiny_checkpoint(path, seed=5)
    audios = {"en": (speech_like_audio(0.9, seed=1), "en"),
              "auto": (speech_like_audio(1.1, seed=2), None)}
    jo = jr.DecodeOptions(temperature_increment=0.0, q8_cross_kv=True)
    to = trl.DecodeOptions(temperature_increment=0.0, q8_cross_kv=True)
    ref_be = JaxBatchedEngine(JaxEngine.from_ggml(path, dtype=jnp.float32),
                              opts=jo, max_batch=4)
    try:
        want = {k: ref_be.transcribe(a, language=lang)
                for k, (a, lang) in audios.items()}
    finally:
        ref_be.close()
    eng = WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")
    be = BatchedEngine(eng, opts=to, max_batch=4)
    got = {}
    tw.decoder_forward_calls.clear()
    try:
        threads = [threading.Thread(
            target=lambda k=k, a=a, lang=lang: got.__setitem__(
                k, be.transcribe(a, language=lang)))
            for k, (a, lang) in audios.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        be.close()
    assert set(got) == set(audios)
    assert any(lay == "q8" for lay, _, _ in tw.decoder_forward_calls)
    for k in audios:
        assert ts._segments(got[k]) == ts._segments(want[k]), k
        assert got[k].text == want[k].text, k
        assert got[k].language == want[k].language, k


@pytest.mark.parametrize("dtype,env,layout", [
    ("bf16", {}, "packed"),
    ("f32", {}, "plain"),
    ("bf16", {"NWT_NO_KT_XATTN": "1"}, "plain"),
    ("f32", {"NWT_FORCE_KT": "1"}, "packed"),
    ("f32", {"NWT_XATTN_BF16": "1"}, "packed"),
    ("bf16", {"NWT_NO_KT_XATTN": "1", "NWT_XATTN_BF16": "1"}, "packed"),
])
def test_packed_layout_knobs(monkeypatch, dtype, env, layout):
    """The reference's packed-layout knobs, read at each call with the
    card in the TPU's place: ``NWT_NO_KT_XATTN`` opts out of the bf16
    default, ``NWT_FORCE_KT`` forces the layout at any dtype
    (decode/greedy.py:40-46), and ``NWT_XATTN_BF16`` asks for it in
    ``decode_window_dispatch`` whatever the other two say (:352-354).
    Where the reference's ``kt_xattn_default`` does not depend on the
    backend (the two knobs), the port's agrees with it."""
    from nobs_whisper_tpu.decode import greedy as jg
    from nobs_whisper_torch.decode import greedy as tg
    from nobs_whisper_torch.decode import rules as trl
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[dtype]
    if "NWT_NO_KT_XATTN" in env or "NWT_FORCE_KT" in env:
        assert tg.kt_xattn_default(tdt) == jg.kt_xattn_default(jdt)
    cfg, params = _int8_decoder(n_audio_ctx=32)
    xa = torch.zeros(1, cfg.n_audio_ctx, cfg.n_audio_state, dtype=tdt)
    opts = trl.DecodeOptions(sample_len=1)
    tw.decoder_forward_calls.clear()
    tg.decode_window(params, xa, [[cfg.sot]], cfg,
                     trl.build_rule_tables(cfg, opts), opts,
                     compute_dtype=tdt)
    assert {lay for lay, _, _ in tw.decoder_forward_calls} == {layout}


def test_wrappers_do_not_fall_back_off_cpu():
    """Only a CPU tensor takes a plain version: any other device goes to
    the kernel path (and here, with no card, raises); the CPU runs count
    no launch."""
    counts = (tap.k4_launch_count, tap.k5_launch_count, tq.k6_launch_count)
    q = torch.zeros(2, 4, 1, 64, device="meta")
    kv = {"kT": torch.zeros(2, 4, 64, 128, device="meta",
                            dtype=torch.bfloat16),
          "v": torch.zeros(2, 4, 128, 64, device="meta",
                           dtype=torch.bfloat16)}
    with pytest.raises(ValueError, match="unsupported device"):
        tap.cross_attention_decode_bf16(q, kv, 100)
    s = torch.zeros(2, 4, 128, device="meta")
    kq = {"q": torch.zeros(2, 4, 64, 128, device="meta", dtype=torch.int8),
          "s": s}
    vq = {"q": torch.zeros(2, 4, 128, 64, device="meta", dtype=torch.int8),
          "s": s}
    with pytest.raises(ValueError, match="unsupported device"):
        tap.cross_attention_decode_q8(q, kq, vq)
    w = {k: v.to("meta") for k, v in tq.quantize_int8(
        torch.randn(64, 96)).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tq.q8_matmul(torch.zeros(8, 64, device="meta"), w)
    x, wj = _k6_case(8, 64, 96, seed=1)
    tq.q8_matmul(torch.from_numpy(x), _qkv_torch(wj))
    assert (tap.k4_launch_count, tap.k5_launch_count,
            tq.k6_launch_count) == counts
