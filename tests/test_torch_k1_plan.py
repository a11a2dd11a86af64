"""What the CPU can check of K1's and K12's projections on Hopper (the q/k/v
GEMM and the fused o projection on ``csrc/proj_wgmma.cuh``'s int8
``wgmma`` kernels, launched by ``csrc/encoder_attention.cu``): the K-major
weight copies they read, and the signatures, rules and constants that the
wrappers share with the CUDA sources.

* The copies: the encoder's gates take K1 (its q/k/v, and its o under
  ``NWT_ATTN_FUSED=2``) and K12 (``NWT_ATTN_FUSED=3``: q/k/v, o, fc1,
  fc2), and ``models/whisper.py::k_major_weights`` names the stacked
  weights whose K-major copies (``ops/quant.py::k_major``) ``_encode``
  makes at its first call on the card. Each copy is the JAX package's
  quantized ``q`` transposed, through the weight bridge
  (``params_from_jax``); the plain versions go on reading ``q``, so an
  int8 encoder whose weights hold the copies gives the same states on the
  CPU, which are the JAX package's (its Pallas kernels in interpret mode)
  within the knob tests' bounds (``test_torch_encoder_knobs.STATE_TOL``).
* The sources: the two C entries' arguments, the rows and widths K1's
  entry refuses, the o projection's requant chunk (a head pair, one slab of
  the GEMM ring, which takes the kernel's two-accumulator path), and the
  ring stages beside the q tile are read from the files. The kernels
  themselves run on the card (``tests/test_torch_kernels_gpu.py``).
"""

import ctypes
import inspect
import os
import re

import numpy as np
import pytest
import torch

import test_torch_encoder_knobs as tk
from nobs_whisper_torch.core.config import WhisperConfig
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import encoder_attention as ea
from nobs_whisper_torch.ops import fused_layer as fl
from nobs_whisper_torch.ops.quant import k_major, quantize_int8
from nobs_whisper_torch.utils.testing import KernelSpies

CSRC = os.path.join(os.path.dirname(ea.__file__), os.pardir, "csrc")
QKV, O, MLP = ("q_w", "k_w", "v_w"), ("o_w",), ("fc1_w", "fc2_w")
# the knob settings of test_torch_attention_variants.py's turbo gates, and
# the weights each one's kernels read K-major
GATE_CASES = [
    ({"NWT_ATTN_FUSED": "3"}, "K12", MLP + QKV + O),
    ({"NWT_ATTN_FUSED": "3", "NWT_MLP_CHUNKED": "1"}, "K12", MLP + QKV + O),
    ({"NWT_ATTN_FUSED": "3", "NWT_MLP_BF": "640"}, "K12", MLP + QKV + O),
    ({"NWT_ATTN_FUSED": "2"}, "K1", MLP + QKV + O),
    ({"NWT_ATTN_FUSED": "3", "NWT_NO_INT8_MLP": "1"}, "K1", QKV + O),
    ({}, "K1", MLP + QKV),
]
# K12, K1 with the o projection fused, the default K1
REF_CASES = [GATE_CASES[i] for i in (0, 3, 5)]


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    for k in tk.KNOBS:
        monkeypatch.delenv(k, raising=False)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _turbo_gates(knobs, monkeypatch, quantized=True):
    """The gates of a large-v3-turbo encoder (d 1280, 20 heads of 64, ffn
    5120) at bf16, its weights on the meta device (the gates read types
    only)."""
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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("knobs,attention,names", GATE_CASES)
def test_k1_gates_name_the_k_major_weights(monkeypatch, knobs, attention,
                                           names, int8):
    """K1 reads q/k/v K-major, and o with the o projection fused; K12 all
    six; with or without the int8 scores and PV. A float encoder takes K3,
    which reads no int8 weight."""
    if int8:
        knobs = dict(knobs, NWT_ATTN_I8="1", NWT_ATTN_I8PV="1")
    gates = _turbo_gates(knobs, monkeypatch)
    assert gates.attention == gates.qkv == attention
    assert gates.o == (attention if "o_w" in names else None)
    assert tw.k_major_weights(gates) == names
    assert tw.k_major_weights(_turbo_gates(knobs, monkeypatch,
                                           quantized=False)) == ()


def _tiny(knobs, monkeypatch):
    """test_torch_encoder_knobs' tiny int8 encoder (d = 128, two heads of
    64, two layers), quantized by the JAX package and carried across, with
    ``knobs`` set; the weights its bf16 gates read K-major."""
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    cfg, jp, tp, mel = tk._encoder(True, seed=1, dtype="bf16")
    gates = tw.encoder_kernel_gates(cfg, tp["encoder"]["blocks"],
                                    torch.bfloat16)
    return cfg, jp, tp, mel, tw.k_major_weights(gates)


@pytest.mark.parametrize("knobs,attention,names", REF_CASES)
def test_k_major_copies_are_the_jax_q_transposed(monkeypatch, knobs,
                                                 attention, names):
    """Each stacked (L, K, N) weight the gate names gets a contiguous int8
    copy, the JAX package's ``q`` with its last two axes swapped, made
    once; ``_layer`` slices it per layer beside ``q``, which stays as it
    was."""
    cfg, jp, tp, _, got_names = _tiny(knobs, monkeypatch)
    assert got_names == names
    blocks, jblocks = tp["encoder"]["blocks"], jp["encoder"]["blocks"]
    for name in names:
        assert "qt" not in blocks[name]
        qt = k_major(blocks[name])
        assert qt.is_contiguous() and qt.dtype == torch.int8
        want = np.asarray(jblocks[name]["q"])
        np.testing.assert_array_equal(qt.numpy(), np.swapaxes(want, -1, -2))
        assert k_major(blocks[name]) is qt
        np.testing.assert_array_equal(blocks[name]["q"].numpy(), want)
        for i in range(cfg.n_audio_layer):
            p = tw._layer(blocks, i)[name]
            assert p["qt"].is_contiguous()
            assert torch.equal(p["qt"], p["q"].t())


@pytest.mark.parametrize("knobs,attention,names", REF_CASES)
def test_encoder_with_k_major_copies_matches_reference(monkeypatch, knobs,
                                                       attention, names):
    """On the CPU the int8 encoder at bf16 takes K1 or K12's plain version,
    which reads ``q``: with the copies in its weights it gives the same
    states as without them, through the same kernels as the JAX package
    (run op by op, its Pallas kernels in interpret mode), whose states it
    matches within ``STATE_TOL``."""
    cfg, jp, tp, mel, _ = _tiny(knobs, monkeypatch)
    ref, want = tk._reference(monkeypatch, cfg, jp, mel, "bf16")
    x = torch.from_numpy(mel)
    plain = tw.encode(tp, x, cfg, compute_dtype=torch.bfloat16)
    blocks = tp["encoder"]["blocks"]
    for name in names:
        k_major(blocks[name])
    spies = KernelSpies(monkeypatch.setattr, kernels=tk.ENCODER)
    got = tw.encode(tp, x, cfg, compute_dtype=torch.bfloat16)
    assert spies.calls == want
    assert want[ea.variant(attention, "o_w" in names and attention == "K1")
                ] == cfg.n_audio_layer
    assert torch.equal(got, plain)
    tk._states_close(got.float().numpy(), ref, "bf16")


def _args(macro, src):
    """The argument kinds ("ptr", "int", "float") of a #define'd list."""
    body = re.search(rf"#define {macro}(.*?)\n#define", src, re.S).group(1)
    args = [a.strip(" \\\n") for a in body.replace("\\\n", " ").split(",")]
    return ["ptr" if "*" in a else a.split()[0] for a in args]


def _entry_args(src, fn, macro_kinds):
    """The kinds of C entry ``fn``'s arguments, its macro expanded."""
    sig = re.search(rf'extern "C" int {fn}\((.*?)\)\s*\{{', src,
                    re.S).group(1)
    kinds = []
    for a in (a.strip() for a in sig.split(",")):
        kinds += (macro_kinds if a == "NWT_K1_ARGS" else
                  ["ptr" if "*" in a else a.split()[0]])
    return kinds


def _ctypes_kinds(sig):
    return [{ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float"}[t] for t in sig]


def test_c_signatures_match_the_wrappers():
    """K1's entry takes its 28 pointers (inputs, output, workspace), B, T,
    d, n_real, the softmax scale, the flags and the stream, and K12's K1's
    then its MLP's twelve pointers, six ints, the scale, the flags and the
    stream, as the wrappers declare them for ctypes."""
    src = _source("encoder_attention.cu")
    k1 = _args("NWT_K1_ARGS", src)
    assert k1 == ["ptr"] * 28
    fn = "nwt_encoder_attention_fused_qkv"
    assert _entry_args(src, fn, k1) == _ctypes_kinds(ea._SIG[fn])
    assert _ctypes_kinds(ea._SIG[fn])[28:] == ["int"] * 4 + [
        "float", "int", "ptr"]
    fn = "nwt_encoder_layer_fused"
    got = _entry_args(_source("fused_layer.cu"), fn, k1)
    assert got == _ctypes_kinds(fl._SIG[fn])
    assert got[28:] == ["ptr"] * 12 + ["int"] * 6 + ["float", "int", "ptr"]


def test_row_and_width_rules_match_the_wrapper():
    """K1's entry refuses what the wrapper refuses: T not a multiple of 64,
    d not a multiple of 128, n_real outside (0, T]."""
    src = " ".join(_source("encoder_attention.cu").split())
    assert ("if (B < 1 || T < 64 || T % 64 || d % 128 || n_real < 1 || "
            "n_real > T) return cudaErrorInvalidValue;") in src
    ops = inspect.getsource(ea.fused_qkv_operands)
    assert "t % 64 or not 0 < n_real <= t" in ops
    assert "d % 128 == 0" in inspect.getsource(
        ea.encoder_attention_fused_qkv)
    assert "d % 128 == 0" in inspect.getsource(fl.encoder_layer_fused)


def _constant(src, name):
    m = re.findall(rf"constexpr int [^;]*\b{name} = (\d+)[,;]", src)
    assert len(m) == 1, name
    return int(m[0])


def test_fused_o_chunk_is_a_head_pair_and_a_slab():
    """The o projection's requant chunk is the wrapper's head pair, sizes
    its scale workspace, and is one slab of the GEMM ring, which the fc2
    kernel takes with its two int32 accumulator sets."""
    ea_src = _source("encoder_attention.cu")
    chunk = _constant(ea_src, "O_CHUNK")
    assert chunk == ea.PAIR == _constant(_source("gemm_s8_wgmma.cuh"),
                                         "G8_BK")
    assert "M, d, d, O_CHUNK};" in ea_src
    proj = " ".join(_source("proj_wgmma.cuh").split())
    assert ("auto kernel = a.block_f == G8_BK ? mlp_fc2_kernel<T, true> : "
            "mlp_fc2_kernel<T, false>;") in proj
    a32, aq, sa = ea.fused_o_workspace(300, 256, torch.device("cpu"))
    assert (a32.dtype, aq.dtype, sa.dtype) == (torch.float32, torch.int8,
                                               torch.float32)
    assert tuple(a32.shape) == tuple(aq.shape) == (300, 256)
    assert tuple(sa.shape) == (300, 256 // chunk)


def test_q_type_and_ring_stages():
    """Under the int8 scores K1 writes q in f32 and unscaled (the wrapper's
    q workspace is f32 then), k and v in bf16, from one launch whose f32 q
    tile leaves 5 ring stages; otherwise q in bf16, pre-scaled, 6 stages.
    The stage counts follow from the headers' constants as
    ``proj_stages`` computes them."""
    ea_src = " ".join(_source("encoder_attention.cu").split())
    assert ("e = s8 ? launch_qkv_proj<bf16, false, float>(xq, sx, wq, sq, "
            "bq, wk, sk, wv, sv, bv, q, k, v, 1.0f, M, d, st) : "
            "launch_qkv_proj<bf16, true, bf16>(xq, sx, wq, sq, bq, wk, sk, "
            "wv, sv, bv, q, k, v, sm_scale, M, d, st);") in ea_src
    assert ("dtype=torch.float32 if int8_scores else torch.bfloat16"
            in inspect.getsource(ea.fused_qkv_operands))
    proj = _source("proj_wgmma.cuh")
    g8 = _source("gemm_s8_wgmma.cuh")
    bn, most = _constant(proj, "K10_BN"), _constant(proj, "PROJ_MAX_STAGES")
    bk = _constant(g8, "G8_BK")
    budget = re.search(r"BUDGET = (\d+) - (\d+);", g8).groups()
    budget = int(budget[0]) - int(budget[1])
    stage = (128 + bn) * bk
    for q_bytes, want in ((4, 5), (2, 6)):
        tile = bn // (128 // q_bytes) * 128 * 128
        assert min(most, (budget - tile) // stage) == want
    assert "its 64 KB tile leaving 5 ring stages" in ea_src
