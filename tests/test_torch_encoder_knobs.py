"""The encoder's knobs on the CPU: K8 (``encoder_mlp_int8``), K10
(``encoder_qkv_int8``), K11 (``residual_o_int8``) and K13
(``encoder_stem_fused``) against the Pallas kernels in interpret mode, the
encoder gates against the reference's for every knob, and the knob slice
(``NWT_INT8_QKV NWT_MLP_CHUNKED NWT_STEM_FUSED``) against the reference.

The port's wrappers run the plain versions for CPU tensors; on the card
they launch the CUDA kernels (tests/test_torch_kernels_gpu.py). Inputs are
made with numpy from a seed and cross as numpy arrays.

The reference takes K10 and K11 on a TPU only: ``use_int8_qkv`` asks for
``jax.default_backend() == "tpu"`` and one device (whisper.py:296-298),
which interpret mode on this 8-device CPU mesh does not give, and it calls
them without ``interpret=`` (:452, :521). :func:`route_reference` shows the
reference's ``_encode`` one TPU (a ``jax`` whose backend is "tpu" with one
device, inside ``_encode`` only: the decoder's TPU gates, whisper.py:715,
:799, :814 and decode/greedy.py:29-46, see the real backend) and routes K10
and K11 to interpret mode. It also counts every encoder kernel the
reference takes.

Tolerances, each with its reason:

* K10, K11 and K8 plain against the Pallas kernels: both compute LN and
  the row scales in f32 and the int8 products exactly; f32 summation order
  can move one activation across an int8 rounding boundary, which moves
  its row's outputs by about one int8 step of that row times a weight. The
  JAX tests' ceiling is 0.05 (tests/test_fused_qkv.py:37,51,
  test_fused_mlp.py:78). Readings on seeds 0-3 at both activation types:
  largest difference 1.6e-2 (K10), 7.8e-3 (K11), 1.6e-2 (K8), mean at
  most 3.1e-5: held to 0.05 and a mean of 1e-4.
* K13 plain against the Pallas kernel: the same bf16 operands and rounding
  points, f32 sums in another order and another f32 tanh; a bf16 output
  can move by one step. Readings on seeds 0-3: at most a third of a step.
  Held to one bf16 step elementwise (rtol 2^-7, atol 2^-9), under the JAX
  tests' 3e-2 (test_conv_stem.py:34-36).
* Whole encoders: see :data:`STATE_TOL`.
"""

import collections
import contextlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nobs_whisper_tpu.models import whisper as jw
from nobs_whisper_tpu.ops import conv_stem as jcs
from nobs_whisper_tpu.ops import encoder_attention as jea
from nobs_whisper_tpu.ops import fused_layer as jfl
from nobs_whisper_tpu.ops import fused_mlp as jfm
from nobs_whisper_tpu.ops import fused_qkv as jfq
from nobs_whisper_tpu.ops.quant import quantize_encoder_params as jquant
from nobs_whisper_tpu.ops.quant import quantize_int8 as jquantize_int8
from nobs_whisper_tpu.utils.testing import tiny_test_config
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import conv_stem as cs
from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops import fused_qkv as fq
from nobs_whisper_torch.utils.testing import KernelSpies

BF16_STEP = dict(rtol=2.0 ** -7, atol=2.0 ** -9)
KERNEL_TOL, KERNEL_MEAN = 5e-2, 1e-4
ENCODER = KernelSpies.ENCODER
KNOBS = ("NWT_NO_FLASH", "NWT_LIB_FLASH", "NWT_NO_INT8_MLP", "NWT_INT8_QKV",
         "NWT_ATTN_BHTD", "NWT_ATTN_BQ", "NWT_ATTN_I8", "NWT_ATTN_I8PV",
         "NWT_ATTN_FUSED", "NWT_STEM_FUSED", "NWT_MLP_CHUNKED",
         "NWT_MLP_BF", "NWT_MLP_BM", "NWT_QKV_BM", "NWT_ATTN_S1",
         "NWT_ATTN_PV1")
SLICE = {"NWT_INT8_QKV": "1", "NWT_MLP_CHUNKED": "1", "NWT_STEM_FUSED": "1"}
FUSED3_I8 = {"NWT_ATTN_FUSED": "3", "NWT_ATTN_I8": "1", "NWT_ATTN_I8PV": "1"}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)


def _np(a):
    return np.array(a, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(_np(a)).to(dtype)


def _qt(w):
    return {"q": torch.from_numpy(np.array(w["q"])),
            "s": torch.from_numpy(np.array(w["s"], np.float32))}


# ---------------------------------------------------------------------------
# K10, K11, K8 and K13: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _rows(seed, m=300, d=256, dtype=jnp.bfloat16):
    """tests/test_fused_qkv.py::_mk: m = 300 rows (not a multiple of the
    kernels' 128-row block), d = 256."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(m, d).astype(np.float32) * 0.5, dtype)
    g = jnp.asarray(1.0 + 0.1 * rng.randn(d).astype(np.float32))
    b = jnp.asarray(0.1 * rng.randn(d).astype(np.float32))
    ws = [jquantize_int8(jnp.asarray(rng.randn(d, d).astype(np.float32)
                                     * d ** -0.5)) for _ in range(4)]
    q_b = jnp.asarray(0.1 * rng.randn(d).astype(np.float32))
    v_b = jnp.asarray(0.1 * rng.randn(d).astype(np.float32))
    return x, g, b, ws, q_b, v_b


def _close(got, want, tol=KERNEL_TOL, mean=KERNEL_MEAN):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() < tol, diff.max()
    assert diff.mean() < mean, diff.mean()


DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k10_plain_matches_pallas_interpret(dtype):
    jdt, tdt = DTYPES[dtype]
    x, g, b, (wq, wk, wv, _), q_b, v_b = _rows(0, dtype=jdt)
    want = jfq.encoder_qkv_int8(x, g, b, wq, q_b, wk, wv, v_b, block_m=128,
                                interpret=True)
    targs = (_t(x, tdt), _t(g), _t(b), _qt(wq), _t(q_b), _qt(wk), _qt(wv),
             _t(v_b))
    got = fq.encoder_qkv_int8(*targs)
    for z, w in zip(got, want):
        assert z.dtype == tdt
        _close(z.float(), w)
    # the XLA path the kernel replaces, in both packages
    ref = jfq.qkv_reference(x, g, b, wq, q_b, wk, wv, v_b)
    for z, w in zip(fq.qkv_reference(*targs), ref):
        _close(z.float(), w)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k11_plain_matches_pallas_interpret(dtype):
    jdt, tdt = DTYPES[dtype]
    x, _, _, (_, _, _, wo), _, _ = _rows(1, dtype=jdt)
    rng = np.random.RandomState(2)
    a = jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.5, jdt)
    o_b = jnp.asarray(0.1 * rng.randn(x.shape[1]).astype(np.float32))
    want = jfq.residual_o_int8(x, a, wo, o_b, block_m=128, interpret=True)
    targs = (_t(x, tdt), _t(a, tdt), _qt(wo), _t(o_b))
    got = fq.residual_o_int8(*targs)
    assert got.dtype == tdt
    _close(got.float(), want)
    _close(fq.residual_o_reference(*targs).float(),
           jfq.residual_o_reference(x, a, wo, o_b))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("block_f", [128, 256])
def test_k8_plain_matches_pallas_interpret(block_f, dtype):
    """m = 300 rows, d = 256, ffn = 512: four or two requant chunks. K8's
    plain version is K2's at equal block_f, bit for bit (the two Pallas
    kernels agree the same way, tests/test_fused_mlp.py:81-108)."""
    jdt, tdt = DTYPES[dtype]
    m, d, f = 300, 256, 512
    rng = np.random.RandomState(block_f)
    x = jnp.asarray(rng.randn(m, d).astype(np.float32) * 0.5, jdt)
    g = jnp.asarray(1.0 + 0.1 * rng.randn(d).astype(np.float32))
    b = jnp.asarray(0.1 * rng.randn(d).astype(np.float32))
    fc1 = jquantize_int8(jnp.asarray(rng.randn(d, f).astype(np.float32)
                                     * d ** -0.5))
    b1 = jnp.asarray(0.1 * rng.randn(f).astype(np.float32))
    fc2 = jquantize_int8(jnp.asarray(rng.randn(f, d).astype(np.float32)
                                     * f ** -0.5))
    b2 = jnp.asarray(0.1 * rng.randn(d).astype(np.float32))
    want = jfm.encoder_mlp_int8(x, g, b, fc1, b1, fc2, b2, block_m=128,
                                block_f=block_f, interpret=True)
    targs = (_t(x, tdt), _t(g), _t(b), _qt(fc1), _t(b1), _qt(fc2), _t(b2))
    got = fm.encoder_mlp_int8(*targs, block_f=block_f)
    assert got.dtype == tdt
    _close(got.float(), want)
    torch.testing.assert_close(
        got, fm.encoder_mlp_int8_resident(*targs, block_f=block_f),
        rtol=0, atol=0)


def _stem_inputs(c_in, n_frames, d=128, seed=0, b=2):
    """tests/test_conv_stem.py::_setup."""
    rng = np.random.RandomState(seed)
    mel = rng.randn(b, c_in, n_frames).astype(np.float32) * 0.5
    w1 = rng.randn(3, c_in, d).astype(np.float32) * (3 * c_in) ** -0.5
    b1 = 0.1 * rng.randn(d).astype(np.float32)
    w2 = rng.randn(3, d, d).astype(np.float32) * (3 * d) ** -0.5
    b2 = 0.1 * rng.randn(d).astype(np.float32)
    pos = 0.1 * rng.randn(n_frames // 2, d).astype(np.float32)
    return mel, w1, b1, w2, b2, pos


def _stem_check(args, t_pad):
    want = _np(jcs.encoder_stem_fused(*(jnp.asarray(a) for a in args),
                                      t_pad, interpret=True))
    got = cs.encoder_stem_fused(*(torch.from_numpy(a) for a in args), t_pad)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **BF16_STEP)
    t_half = args[0].shape[-1] // 2
    assert not got[:, t_half:].any()          # padded rows: exact zeros
    return got


@pytest.mark.parametrize("c_in,n_frames,t_pad", [
    (80, 64, 32),            # 80 mel channels (the TPU lane-pads to 128)
    (128, 64, 32),           # large-v3's 128
    (80, 64, 48),            # 16 zero rows past t_real
    (128, 100, 56)])         # t_real = 50, not a multiple of 8
def test_k13_plain_matches_pallas_interpret(c_in, n_frames, t_pad):
    _stem_check(_stem_inputs(c_in, n_frames, seed=c_in + t_pad), t_pad)


def test_k13_boundary_rows():
    """Impulses at the first and the last frame reach the first and last
    output rows only through the convs' zero padding
    (tests/test_conv_stem.py:55-66)."""
    mel, *rest = _stem_inputs(80, 32, seed=3, b=1)
    mel = np.zeros_like(mel)
    mel[0, :, 0], mel[0, :, -1] = 1.0, -1.0
    _stem_check((mel, *rest), 24)


def test_k13_stem_reference_is_the_unfused_stem():
    """``stem_reference`` is each package's unfused bf16 stem; the fused
    stem differs from it only in the gelu's internal precision."""
    args = _stem_inputs(80, 64, seed=5)
    want = _np(jcs.stem_reference(*(jnp.asarray(a) for a in args)))
    got = cs.stem_reference(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_STEP)
    fused = cs.encoder_stem_fused(*(torch.from_numpy(a) for a in args), 32)
    np.testing.assert_allclose(fused.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


def _conv_stem_cu():
    return open(os.path.join(os.path.dirname(cs.__file__), os.pardir, "csrc",
                             "conv_stem.cu")).read()


def test_k13_mel_channel_quantum_matches_the_kernel():
    """The wrapper allocates the kernel's bf16 copy of the mel with C_in
    rounded up to ``MEL_CQ`` channels; ``csrc/conv_stem.cu`` lays the rows
    out with its own ``MEL_CQ``."""
    import re
    assert re.findall(r"constexpr int MEL_CQ = (\d+);", _conv_stem_cu()) == [
        str(cs.MEL_CQ)]


def test_k13_operand_copies_only_what_the_kernel_cannot_read():
    """The wrapper hands the kernel bf16 weights as they lie: a contiguous,
    16-byte aligned tensor of the wanted type is passed on, not copied; a
    tensor of another type, a strided view or a view off the 16-byte grid
    is copied into one the kernel reads."""
    w = torch.zeros(3, 80, 128, dtype=torch.bfloat16)
    assert cs._operand(w, torch.bfloat16) is w
    for z in (w.float(), w.transpose(1, 2), w.flatten()[1:1 + 3 * 80 * 127]):
        got = cs._operand(z, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, z.to(
            torch.bfloat16))


def test_k13_signature_matches_the_c_entry():
    """``_SIG`` declares each argument of ``nwt_encoder_stem`` in order:
    a pointer for each pointer (and the stream), an int for each int."""
    import ctypes
    import re
    src = _conv_stem_cu()
    params = re.search(r'extern "C" int nwt_encoder_stem\(([^)]*)\)',
                       src).group(1).split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert cs._SIG["nwt_encoder_stem"] == want


# ---------------------------------------------------------------------------
# the reference's encoder on one TPU, its kernels counted
# ---------------------------------------------------------------------------

class _OneTpu:
    """``jax`` as the reference's ``_encode`` sees it on one TPU."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"

    @staticmethod
    def device_count():
        return 1


class Taken(Exception):
    """The reference reached a kernel the port does not have."""


_KERNELS = {}


def _compiled(fn, args, kwargs):
    """``fn(*args, **kwargs)`` compiled once per shape and static argument
    (interpret mode compiles the kernel body at every call under
    ``jax.disable_jit``; compiling the whole call caches it), the rest of
    the reference as the caller runs it. Python scalars and keywords are
    static, and so are the knobs, which some kernels read as they trace
    (``NWT_ATTN_S1``, ``NWT_ATTN_PV1``)."""
    static = {i: z for i, z in enumerate(args)
              if isinstance(z, (int, float))}
    key = (fn, tuple(sorted(static.items())),
           tuple(sorted((n, repr(v)) for n, v in kwargs.items())),
           tuple(sorted((k, v) for k, v in os.environ.items()
                        if k.startswith("NWT_"))))
    if key not in _KERNELS:
        def call(*arrays):
            it = iter(arrays)
            return fn(*(static[i] if i in static else next(it)
                        for i in range(len(args))), **kwargs)
        _KERNELS[key] = jax.jit(call)
    with jax.disable_jit(False):
        return _KERNELS[key](*(z for i, z in enumerate(args)
                               if i not in static))


def route_reference(monkeypatch, interpret=True):
    """Count the encoder kernels the reference takes, by variant ("K1-o",
    "K12-i8s-i8pv", ...; per layer: its scan runs as a loop under
    ``jax.disable_jit``), with ``_encode`` on one TPU and, with
    ``interpret``, its kernels in interpret mode. The library's flash
    kernel, which the port does not have, ends the run with
    :class:`Taken`."""
    calls = collections.Counter()
    real_encode = jw._encode

    def encode_on_tpu(*a, **k):
        jw.jax = _OneTpu()
        try:
            with (jw.kernel_override("interpret") if interpret
                  else contextlib.nullcontext()):
                return real_encode(*a, **k)
        finally:
            jw.jax = jax

    monkeypatch.setattr(jw, "_encode", encode_on_tpu)

    def spy(mod, name, key, route=False):
        real = getattr(mod, name)

        def run(*a, **k):
            calls[ea.variant(key, k.get("wo") is not None,
                             bool(k.get("int8_scores")),
                             bool(k.get("int8_pv")))] += 1
            if route:
                k = dict(k, interpret=True)
            if not k.get("interpret"):
                return real(*a, **k)         # the library kernel's gate
            return _compiled(real, a, k)
        monkeypatch.setattr(mod, name, run)

    spy(jea, "encoder_attention_fused_qkv", "K1")
    spy(jea, "encoder_attention_btd", "K3")
    spy(jea, "encoder_attention", "K9")
    spy(jfl, "encoder_layer_fused", "K12")
    spy(jfm, "encoder_mlp_int8_resident", "K2")
    spy(jfm, "encoder_mlp_int8", "K8")
    spy(jfq, "encoder_qkv_int8", "K10", route=True)
    spy(jfq, "residual_o_int8", "K11", route=True)
    spy(jcs, "encoder_stem_fused", "K13")

    def taken(what):
        def run(*a, **k):
            raise Taken(what)
        return run
    from jax.experimental.pallas.ops.tpu import flash_attention as lib
    monkeypatch.setattr(lib, "flash_attention", taken("library flash"))
    return calls


def _encoder(quantized, seed=1, dtype="bf16"):
    """A tiny encoder whose heads pair (d = 128, two heads of 64, two
    layers, 80 mel channels), biases and LayerNorm gains drawn at random
    (bias 0.1 N(0, 1), gain 1 + 0.1 N(0, 1)) as a trained checkpoint has
    them; int8 when ``quantized``. Returns cfg, JAX and torch params and a
    mel batch of two windows."""
    jdt, tdt = DTYPES[dtype]
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32, n_text_ctx=64)
    jp = jw.init_params(jax.random.PRNGKey(seed), cfg, dtype=jdt)
    rng = np.random.RandomState(seed + 100)

    def draw(path, a):
        name = path[-1].key
        if not name.endswith(("_b", "_g")):
            return a
        return jnp.asarray(0.1 * rng.randn(*a.shape) + name.endswith("_g"),
                           jdt)
    jp = dict(jp, encoder=jax.tree_util.tree_map_with_path(
        draw, jp["encoder"]))
    if quantized:
        jp = jquant(jp)
    tp = tw.params_from_jax(jax.tree.map(
        lambda a: np.array(a) if a.dtype == np.int8 else _np(a), jp),
        dtype=tdt)
    mel = np.random.RandomState(seed + 4).randn(
        2, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32)
    return cfg, jp, tp, mel


def _reference(monkeypatch, cfg, jp, mel, dtype, states=True):
    """The reference's encoder with its kernels counted: op by op
    (``jax.disable_jit``, the scan a loop: counts per layer) when
    ``states``, else traced alone (``jax.eval_shape``: counts per traced
    layer, scaled here to the model's layers). At f32 the reference gets
    ``NWT_NO_FLASH=1``: interpret mode turns its attention kernels on at
    any dtype, a TPU only at bf16. Returns (states or None, counts)."""
    calls = route_reference(monkeypatch)
    jdt = DTYPES[dtype][0]
    run = lambda: jw.encode(jp, jnp.asarray(mel), cfg, compute_dtype=jdt)
    with monkeypatch.context() as m:
        if dtype == "f32":
            m.setenv("NWT_NO_FLASH", "1")
        if states:
            with jax.disable_jit():
                out = _np(run())
        else:
            jax.eval_shape(run)
            out = None
            for k in calls:
                calls[k] *= 1 if k == "K13" else cfg.n_audio_layer
    want = dict.fromkeys(ENCODER, 0)
    want.update(calls)
    return out, want


def run_both(monkeypatch, model, dtype, knobs, seed=1, states=True):
    """The reference's encoder (kernels counted) and the port's (plain
    versions counted) on one model with ``knobs`` set. Returns (port
    states, reference states or None, port counts, reference counts)."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg, jp, tp, mel = _encoder(model == "int8", seed, dtype)
    ref, want = _reference(monkeypatch, cfg, jp, mel, dtype, states)
    tdt = DTYPES[dtype][1]
    spies = KernelSpies(monkeypatch.setattr, kernels=ENCODER)
    got = tw.encode(tp, torch.from_numpy(mel), cfg, compute_dtype=tdt)
    assert got.dtype == tdt
    assert tuple(got.shape) == (2, cfg.n_audio_ctx, cfg.n_audio_state)
    return got.float().numpy(), ref, spies.calls, want


# ---------------------------------------------------------------------------
# every knob: the port's routes are the reference's
# ---------------------------------------------------------------------------

KNOB_CASES = {
    "none": {},
    "NO_FLASH": {"NWT_NO_FLASH": "1"},
    "NO_INT8_MLP": {"NWT_NO_INT8_MLP": "1"},
    "INT8_QKV": {"NWT_INT8_QKV": "1"},
    "INT8_QKV+BM": {"NWT_INT8_QKV": "1", "NWT_QKV_BM": "64",
                    "NWT_MLP_BM": "64"},
    "ATTN_BHTD": {"NWT_ATTN_BHTD": "1"},
    "ATTN_BQ=128": {"NWT_ATTN_BQ": "128"},
    "ATTN_BQ=512+BHTD": {"NWT_ATTN_BQ": "512", "NWT_ATTN_BHTD": "1"},
    "ATTN_FUSED=0": {"NWT_ATTN_FUSED": "0"},
    "ATTN_FUSED=''": {"NWT_ATTN_FUSED": ""},
    "ATTN_FUSED=1": {"NWT_ATTN_FUSED": "1"},
    "ATTN_S1+PV1": {"NWT_ATTN_S1": "1", "NWT_ATTN_PV1": "1"},
    "STEM_FUSED": {"NWT_STEM_FUSED": "1"},
    "STEM_FUSED+BHTD": {"NWT_STEM_FUSED": "1", "NWT_ATTN_BHTD": "1"},
    "STEM_FUSED+BQ=128": {"NWT_STEM_FUSED": "1", "NWT_ATTN_BQ": "128"},
    "MLP_CHUNKED": {"NWT_MLP_CHUNKED": "1"},
    "MLP_BF=128": {"NWT_MLP_BF": "128"},
    "MLP_CHUNKED+BF=256": {"NWT_MLP_CHUNKED": "1", "NWT_MLP_BF": "256"},
    "I8+INT8_QKV": {"NWT_ATTN_I8": "1", "NWT_INT8_QKV": "1"},
    "slice": SLICE,
    "ATTN_FUSED=2": {"NWT_ATTN_FUSED": "2"},
    "ATTN_FUSED=3": {"NWT_ATTN_FUSED": "3"},
    "ATTN_I8": {"NWT_ATTN_I8": "1"},
    "ATTN_I8PV": {"NWT_ATTN_I8PV": "1"},
    "ATTN_I8+I8PV": {"NWT_ATTN_I8": "1", "NWT_ATTN_I8PV": "1"},
    "FUSED=2+I8": {"NWT_ATTN_FUSED": "2", "NWT_ATTN_I8": "1"},
    "FUSED=3+I8+I8PV": FUSED3_I8,
    "FUSED=3+NO_INT8_MLP": {"NWT_ATTN_FUSED": "3", "NWT_NO_INT8_MLP": "1"},
    "FUSED=3+MLP_CHUNKED": {"NWT_ATTN_FUSED": "3", "NWT_MLP_CHUNKED": "1"},
}


def expected_routes(model, dtype, knobs):
    """Per encoder batch of the two-layer model, what the reference's
    gates take, written out from whisper.py:266-558 with one TPU: the
    table the port's gates must follow."""
    on = lambda k: bool(knobs.get(k))
    bf16, q = dtype == "bf16", model == "int8"
    flash = bf16 and not on("NWT_NO_FLASH")
    btd = flash and not on("NWT_INT8_QKV") and not on("NWT_ATTN_BHTD")
    fused = int(knobs.get("NWT_ATTN_FUSED", "1") or "0")
    int8_mlp = q and not on("NWT_NO_INT8_MLP")
    i8 = (on("NWT_ATTN_I8"), on("NWT_ATTN_I8PV"))
    k12 = btd and q and fused >= 3 and int8_mlp
    r = dict.fromkeys(ENCODER, 0)
    if k12:
        r[ea.variant("K12", False, *i8)] = 2
    elif btd and q and fused:
        r[ea.variant("K1", fused >= 2, *i8)] = 2
    elif btd:
        r[ea.variant("K3", False, *i8)] = 2
    elif flash:
        r["K9"] = 2
    if on("NWT_INT8_QKV") and q and not btd:
        r["K10"] = r["K11"] = 2
    if int8_mlp and not k12:
        r["K8" if on("NWT_MLP_CHUNKED") else "K2"] = 2
    r["K13"] = int(bf16 and on("NWT_STEM_FUSED"))
    return r


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("model", ["int8", "float"])
@pytest.mark.parametrize("case", list(KNOB_CASES))
def test_encoder_knob_routes_match_reference(monkeypatch, case, model,
                                             dtype):
    """For each knob, an int8 and a float tiny encoder at bf16 and f32:
    the port takes the kernels the reference's gates take, as often, and
    as the table in :func:`expected_routes` says."""
    knobs = KNOB_CASES[case]
    _, _, port, want = run_both(monkeypatch, model, dtype, knobs,
                                states=False)
    assert want == expected_routes(model, dtype, knobs), want
    assert port == want


# Whole encoders (two layers, through ln_post) against the reference run
# op by op. f32: the two packages share every rounding rule; an int8
# activation or requantized gelu value that f32 summation order moves
# across a rounding boundary moves its row by about one int8 step, and
# attention spreads that row's change to every row of the next layer.
# bf16: besides, a bf16 rounding flip spreads the same way
# (test_torch_model.py::test_float_bf16_encoder_matches_interpret).
# Readings over the knob cases on weight seeds 1 and 2 (all four models):
# largest difference 4.7e-2 (bf16) and 1.7e-2 (f32), mean difference at
# most 2.4e-3 (bf16) and 1.2e-3 (f32, after one such flip; 1.5e-7 without).
# A knob that changes the function moves the reference's states from its
# knobless run by a mean of at least 6.8e-3 (bf16) and 4.1e-3 (f32) there.
STATE_TOL = {"bf16": (5e-2, 4e-3), "f32": (2e-2, 2e-3)}


def _states_close(got, ref, dtype):
    tol, mean = STATE_TOL[dtype]
    diff = np.abs(got - ref)
    assert diff.max() < tol, diff.max()
    assert diff.mean() < mean, diff.mean()


# (case, model, dtype) where the knob changes the reference's function:
# K1 left for LN + the XLA projections (NO_FLASH, INT8_QKV, ATTN_BHTD,
# ATTN_FUSED=0 or empty), the XLA MLP for K2 (NO_INT8_MLP), K13's gelu
# for the unfused stem's (STEM_FUSED), the fc2 requantization chunk
# (MLP_BF; the tiny model's ffn of 512 makes 1280 and 2560 the same
# chunk, so MLP_CHUNKED alone does not change it)
FUNCTION_CASES = [
    ("NO_FLASH", "int8", "bf16"), ("NO_INT8_MLP", "int8", "f32"),
    ("INT8_QKV", "int8", "bf16"), ("ATTN_BHTD", "int8", "bf16"),
    ("ATTN_FUSED=0", "int8", "bf16"), ("STEM_FUSED", "int8", "bf16"),
    ("MLP_BF=128", "int8", "f32"), ("MLP_CHUNKED+BF=256", "int8", "bf16"),
    ("ATTN_FUSED=2", "int8", "bf16"), ("ATTN_FUSED=3", "int8", "bf16"),
    ("ATTN_I8", "int8", "bf16"), ("ATTN_I8", "float", "bf16"),
    ("ATTN_I8PV", "int8", "bf16"), ("ATTN_I8+I8PV", "int8", "bf16"),
]
_BASE = {}


@pytest.mark.parametrize("case,model,dtype", FUNCTION_CASES)
def test_encoder_knob_states_match_reference(monkeypatch, case, model,
                                             dtype):
    """Where a knob changes the encoder's function, the port's states with
    the knob are the reference's within :data:`STATE_TOL`; and the knob
    moves the reference's states from its knobless run by more than that
    bound's mean, so a port that ignored the knob would fail here."""
    if (model, dtype) not in _BASE:
        with monkeypatch.context() as m:
            _BASE[model, dtype] = run_both(m, model, dtype, {})[1]
    got, ref, port, want = run_both(monkeypatch, model, dtype,
                                    KNOB_CASES[case])
    assert port == want
    _states_close(got, ref, dtype)
    moved = np.abs(ref - _BASE[model, dtype]).mean()
    assert moved > STATE_TOL[dtype][1], moved


RAISE_CASES = {
    # knobs: what the reference takes at bf16 that the port does not have
    "LIB_FLASH": ({"NWT_LIB_FLASH": "1"}, "library flash"),
}


@pytest.mark.parametrize("model", ["int8", "float"])
@pytest.mark.parametrize("case", list(RAISE_CASES))
def test_unported_encoder_variants_raise(monkeypatch, case, model):
    """Where the reference takes a kernel the port does not have (the JAX
    library's flash attention), the port raises NotImplementedError naming
    the ROADMAP. The library kernel is off in interpret mode
    (whisper.py:270), so this runs the reference's gates on one TPU
    without it (its first kernel call is the library's). At f32 no
    attention kernel runs, and nothing raises."""
    knobs, variant = RAISE_CASES[case]
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg, jp, tp, mel = _encoder(model == "int8")
    route_reference(monkeypatch, interpret=False)
    with jax.disable_jit(), pytest.raises(Taken, match=variant):
        jw.encode(jp, jnp.asarray(mel), cfg, compute_dtype=jnp.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tw.encode(tp, torch.from_numpy(mel), cfg,
                  compute_dtype=torch.bfloat16)
    cfg, _, tp32, _ = _encoder(model == "int8", dtype="f32")
    assert tw.encoder_kernel_gates(cfg, tp32["encoder"]["blocks"],
                                   torch.float32).attention is None


def test_attn_s1_pv1_leave_the_reference_unchanged(monkeypatch):
    """``NWT_ATTN_S1`` and ``NWT_ATTN_PV1`` reformulate K1's and K3's dots
    with blocks of exact zeros: the reference's states with them are its
    states without, bit for bit, so the port reads neither."""
    states = {}
    for knobs in ({}, {"NWT_ATTN_S1": "1", "NWT_ATTN_PV1": "1"}):
        for model in ("int8", "float"):
            with monkeypatch.context() as m:
                states[model, bool(knobs)] = run_both(m, model, "bf16",
                                                      knobs)[1]
    for model in ("int8", "float"):
        np.testing.assert_array_equal(states[model, True],
                                      states[model, False])


def test_stem_gate_needs_a_whole_window(monkeypatch):
    """K13 needs the whole position table and an even mel length
    (whisper.py:349-353): a ``with_audio_ctx`` encoder (a shorter table)
    takes the unfused stem, in both packages."""
    monkeypatch.setenv("NWT_STEM_FUSED", "1")
    cfg, _, tp, _ = _encoder(True)
    blocks = tp["encoder"]["blocks"]
    gate = lambda n, pos: tw.encoder_kernel_gates(
        cfg, blocks, torch.bfloat16, n, pos).stem
    assert gate(64, 32) == "K13"
    assert gate(48, 24) == "K13"
    assert gate(48, 32) is None          # truncated audio_ctx window
    assert gate(50, 24) is None
    assert tw.encoder_kernel_gates(cfg, blocks, torch.float32).stem is None


# ---------------------------------------------------------------------------
# the slice: the three knobs on, encoder and window program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_knob_slice_encoder_matches_reference(monkeypatch, dtype):
    """The int8 encoder with ``NWT_INT8_QKV NWT_MLP_CHUNKED
    NWT_STEM_FUSED``: at bf16 K13 once, then K10, K9, K11 and K8 in each
    layer; at f32 K10, K11 and K8 (no attention kernel, no K13). Two
    weight seeds."""
    for seed in (0, 2):
        with monkeypatch.context() as m:
            got, ref, port, want = run_both(m, "int8", dtype, SLICE, seed)
        n = 2
        assert port == want == dict(
            dict.fromkeys(ENCODER, 0), K10=n, K11=n, K8=n,
            **({"K9": n, "K13": 1} if dtype == "bf16" else {}))
        _states_close(got, ref, dtype)


# Weight seed of the bf16 window program. Over seeds 0-9 (``PYTHONPATH=.
# python tests/torch_bf16_seed_sweep.py 10 knobs``, three windows a seed)
# greedy tokens agree in every window on seeds 0, 2, 4, 5, 7, 8 and 9 and
# differ in one window on 1, 3 and 6: the bf16 near-ties of a random tiny
# model that test_torch_slice.py describes. Seed 7, as the decode slice.
SLICE_BF16_SEED = 7


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_knob_slice_window_tokens_equal(monkeypatch, dtype):
    """The int8 window program (framed audio -> mel -> encoder with the
    three knobs -> greedy decode) against the reference's with its encoder
    on one TPU: greedy tokens equal, scores to 1e-3 relative
    (test_torch_slice.py). At bf16 the reference runs op by op (its scan a
    loop: kernels counted per layer), at f32 compiled (counted once per
    traced layer)."""
    import test_torch_slice as ts
    for k, v in SLICE.items():
        monkeypatch.setenv(k, v)
    bf16 = dtype == "bf16"
    if not bf16:
        monkeypatch.setenv("NWT_NO_FLASH", "1")    # the TPU's f32 gates
    calls = route_reference(monkeypatch)
    spies = KernelSpies(monkeypatch.setattr, kernels=ENCODER)
    with jax.disable_jit() if bf16 else contextlib.nullcontext():
        got, ref = ts._window_slice(dtype, seed=SLICE_BF16_SEED)
    n = 2
    want = dict(dict.fromkeys(ENCODER, 0), K10=n, K11=n, K8=n,
                **({"K9": n, "K13": 1} if bf16 else {}))
    assert spies.calls == want
    assert dict(calls) == {k: v if k == "K13" or bf16 else v // n
                           for k, v in want.items() if v}
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=1e-4)


# Weight seed of the K12 window program. Over seeds 0-9 (``PYTHONPATH=.
# python tests/torch_bf16_seed_sweep.py 10 fused3``, three windows a seed)
# greedy tokens agree in every window on seeds 0, 2, 5, 7, 8 and 9 and
# differ in one or two windows on 1, 3, 4 and 6: the bf16 near-ties of a
# random tiny model, here behind int8 scores and PV whose per-head scales
# a single upstream flip can move. Seed 7, as the knob slice.
FUSED3_SEED = 7


def test_fused3_int8_window_tokens_equal(monkeypatch):
    """The int8 window program at bf16 with ``NWT_ATTN_FUSED=3
    NWT_ATTN_I8=1 NWT_ATTN_I8PV=1`` (K12 with both int8 variants in each
    layer, no other encoder kernel) against the reference's, its encoder
    on one TPU, run op by op: greedy tokens equal, scores within 2e-3
    relative, no-speech probabilities within 1e-3."""
    import test_torch_slice as ts
    for k, v in FUSED3_I8.items():
        monkeypatch.setenv(k, v)
    calls = route_reference(monkeypatch)
    spies = KernelSpies(monkeypatch.setattr, kernels=ENCODER)
    with jax.disable_jit():
        got, ref = ts._window_slice("bf16", seed=FUSED3_SEED)
    want = dict(dict.fromkeys(ENCODER, 0), **{"K12-i8s-i8pv": 2})
    assert spies.calls == want
    assert dict(calls) == {"K12-i8s-i8pv": 2}
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    # the summed logprobs of 224-token windows: 1.2e-3 relative apart at
    # most here (the int8 scores and PV put a per-head scale, which one
    # upstream flip moves, in front of every score), held to 2e-3
    np.testing.assert_allclose(got[2], ref[2], rtol=2e-3)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-3, atol=1e-4)


def test_knob_kernel_wrappers_do_not_fall_back_off_cpu():
    """Only a CPU tensor takes a plain version: any other device goes to
    the kernel path (and here, with no card, raises)."""
    from nobs_whisper_torch.ops.quant import quantize_int8
    d, meta = 128, "meta"
    qt = lambda *s: {k: v.to(meta) for k, v in quantize_int8(
        torch.randn(*s)).items()}
    w, w1, w2 = qt(d, d), qt(d, 4 * d), qt(4 * d, d)
    x = torch.zeros(64, d, device=meta, dtype=torch.bfloat16)
    v, v4 = torch.zeros(d, device=meta), torch.zeros(4 * d, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fq.encoder_qkv_int8(x, v, v, w, v, w, w, v)
    with pytest.raises(ValueError, match="unsupported device"):
        fq.residual_o_int8(x, x, w, v)
    with pytest.raises(ValueError, match="unsupported device"):
        fm.encoder_mlp_int8(x, v, v, w1, v4, w2, v)
    with pytest.raises(ValueError, match="unsupported device"):
        cs.encoder_stem_fused(
            torch.zeros(1, 80, 64, device=meta),
            torch.zeros(3, 80, d, device=meta), v,
            torch.zeros(3, d, d, device=meta), v,
            torch.zeros(32, d, device=meta), 32)
