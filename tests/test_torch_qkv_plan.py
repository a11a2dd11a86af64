"""What the CPU can check of K10's and K11's Hopper kernels
(``csrc/fused_qkv.cu``): the K-major weight copies they read, and the
signatures, constants and plan that the wrapper shares with the CUDA
source.

* The copies: under ``NWT_INT8_QKV`` the encoder's gates take K10 for a
  quantized ``q_w`` and K11 for a quantized ``o_w``, and
  ``models/whisper.py::k_major_weights`` names the stacked q/k/v/o weights
  whose K-major copies (``ops/quant.py::k_major``) ``_encode`` makes at its
  first call on the card. Each copy is the JAX package's quantized ``q``
  transposed; the plain versions go on reading ``q``, so an encoder whose
  weights hold the copies gives the same states on the CPU. The int8
  weights come from the JAX package's ``quantize_encoder_params`` through
  the weight bridge (``params_from_jax``), as the serving engine's do.
* The source: the four C entries' arguments, the width rule
  ``d % 128 == 0`` and the workspace, which the wrapper shares with it,
  are read from the file. The kernels themselves run on the card
  (``tests/test_torch_kernels_gpu.py``).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

import jax

from nobs_whisper_tpu.models import whisper as jw
from nobs_whisper_tpu.ops.quant import quantize_encoder_params as jquant
from nobs_whisper_tpu.utils.testing import tiny_test_config
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import fused_qkv as fq
from nobs_whisper_torch.ops.quant import k_major

SRC = os.path.join(os.path.dirname(fq.__file__), os.pardir, "csrc",
                   "fused_qkv.cu")
PROJ = ("q_w", "k_w", "v_w", "o_w")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _encoder(seed=2):
    """A tiny int8 encoder (d = 128, two heads, two layers) quantized by
    the JAX package and carried across; its JAX twin's blocks as numpy."""
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    jp = jquant(jw.init_params(jax.random.PRNGKey(seed), cfg))
    tree = jax.tree.map(np.asarray, jp)
    mel = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        1, cfg.n_mels, 2 * cfg.n_audio_ctx).astype(np.float32))
    return cfg, tw.params_from_jax(tree), tree["encoder"]["blocks"], mel


def _gates(params, cfg):
    return tw.encoder_kernel_gates(cfg, params["encoder"]["blocks"],
                                   torch.float32)


def test_int8_qkv_gate_names_the_k_major_weights(monkeypatch):
    """With ``NWT_INT8_QKV`` the gates take K10 and K11 and the copies
    cover q, k, v and o beside K2's fc1 and fc2; without it neither
    kernel and no projection copy."""
    cfg, params, _, _ = _encoder()
    monkeypatch.delenv("NWT_INT8_QKV", raising=False)
    gates = _gates(params, cfg)
    assert gates.qkv is None and gates.o is None
    assert tw.k_major_weights(gates) == ("fc1_w", "fc2_w")
    monkeypatch.setenv("NWT_INT8_QKV", "1")
    gates = _gates(params, cfg)
    assert (gates.qkv, gates.o) == ("K10", "K11")
    assert tw.k_major_weights(gates) == ("fc1_w", "fc2_w") + PROJ


@pytest.mark.parametrize("name", PROJ)
def test_k_major_copy_is_the_jax_q_transposed(name):
    """Each stacked (L, d, d) copy is the JAX package's int8 ``q`` with its
    last two axes swapped, contiguous, made once; ``_layer`` slices it per
    layer beside ``q``."""
    cfg, params, jblocks, _ = _encoder()
    qt = params["encoder"]["blocks"][name]
    assert "qt" not in qt
    got = k_major(qt)
    assert got.is_contiguous() and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.swapaxes(jblocks[name]["q"], -1, -2))
    assert k_major(qt) is got
    np.testing.assert_array_equal(qt["q"].numpy(), jblocks[name]["q"])
    for i in range(cfg.n_audio_layer):
        p = tw._layer(params["encoder"]["blocks"], i)[name]
        assert p["qt"].is_contiguous() and torch.equal(p["qt"], p["q"].t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_with_k_major_copies_is_unchanged_on_cpu(monkeypatch,
                                                         dtype):
    """The CPU runs K10's and K11's plain versions, which read ``q``: with
    ``NWT_INT8_QKV`` set, an encoder whose q/k/v/o hold their K-major
    copies gives the same states, and the CPU path makes no copy of its
    own."""
    monkeypatch.setenv("NWT_INT8_QKV", "1")
    cfg, params, _, mel = _encoder()
    blocks = params["encoder"]["blocks"]
    before = (fq.k10_launch_count, fq.k11_launch_count)
    want = tw.encode(params, mel, cfg, compute_dtype=dtype)
    assert (fq.k10_launch_count, fq.k11_launch_count) == before
    assert not any("qt" in blocks[n] for n in PROJ)
    for n in PROJ:
        k_major(blocks[n])
    assert torch.equal(tw.encode(params, mel, cfg, compute_dtype=dtype),
                       want)


def _source():
    with open(SRC) as f:
        return f.read()


@pytest.mark.parametrize("macro,entries,kinds", [
    ("NWT_QKV_ARGS", ("nwt_encoder_qkv_int8", "nwt_encoder_qkv_int8_f32"),
     ["ptr"] * 16 + ["int"] * 2 + ["ptr"]),
    ("NWT_RES_O_ARGS", ("nwt_residual_o_int8", "nwt_residual_o_int8_f32"),
     ["ptr"] * 8 + ["int"] * 2 + ["ptr"])])
def test_c_signature_matches_the_wrapper(macro, entries, kinds):
    """Each C entry takes the pointers, the two ints (M, d) and the stream
    that ``fq._SIG`` declares for ctypes, and the wrapper names it for
    each activation type."""
    src = _source()
    args = re.search(rf"#define {macro}(.*?)\n#define", src, re.S).group(1)
    args = [a.strip(" \\\n") for a in args.replace("\\\n", " ").split(",")]
    got = ["ptr" if "*" in a else a.split()[0] for a in args]
    assert got == kinds
    assert [a.split()[-1].lstrip("*") for a in args][-3:] == [
        "M", "d", "stream"]
    for fn in entries:
        assert f'extern "C" int {fn}({macro})' in src
        assert [t is ctypes.c_int for t in fq._SIG[fn]] == [
            k == "int" for k in kinds]
    assert set(entries) <= set(fq._ENTRY.values())


def test_width_rule_and_workspace_match_the_kernel():
    """The source refuses what the wrapper refuses (d % 128), and both
    entries take the workspace the wrapper makes: the int8 rows (M, d) and
    their f32 scales (M,)."""
    src = _source()
    assert src.count("if (M < 1 || d % 128) return (int)cudaErrorInvalidValue;"
                     ) == 2
    notes = " ".join(line.strip().lstrip("/").strip()
                     for line in src.splitlines())
    assert "Workspace: xq (M, d) int8, sx (M,) f32." in notes
    assert "Workspace: aq (M, d) int8, sa (M,) f32." in notes
    xq, sx = fq.qkv_workspace(300, 256, torch.device("cpu"))
    assert tuple(xq.shape) == (300, 256) and xq.dtype == torch.int8
    assert tuple(sx.shape) == (300,) and sx.dtype == torch.float32
