"""What the CPU can check of K2's Hopper kernels (``csrc/fused_mlp.cu``):
the K-major weight copies they read, and the constants and plan that the
wrapper shares with the CUDA source.

* The copy: ``ops/quant.py::k_major`` gives a QTensor's ``q`` (K, N) as a
  row-major (N, K) copy, made once and kept under ``"qt"``; ``_layer``
  slices it with ``q``; the plain versions go on reading ``q``, so a
  weight that holds the copy gives the same encoder states on the CPU.
  The int8 weights come from the JAX package's ``quantize_int8`` through
  the weight bridge (``params_from_jax``), as the serving engine's do.
* The plan: fc1's tile width and cluster size for each chunk width, and
  the chunks that take the two-pass variant (no cluster of at most 16
  blocks covers them), are chosen by ``fc1_plan`` in both the source and
  the wrapper, which sizes the workspace by it; the source's constants
  and the C signature are read from the file. The kernels themselves run
  on the card (``tests/test_torch_kernels_gpu.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nobs_whisper_tpu.ops.quant import quantize_int8 as jax_quantize_int8
from nobs_whisper_torch.models import whisper as tw
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops.quant import k_major

SRC = os.path.join(os.path.dirname(fm.__file__), os.pardir, "csrc",
                   "fused_mlp.cu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _bridged(shape, seed):
    """An int8 QTensor quantized by the JAX package, carried across."""
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    qt = {k: np.array(v) for k, v in jax_quantize_int8(jnp.asarray(w)).items()}
    return tw.params_from_jax(qt), qt


@pytest.mark.parametrize("shape", [(256, 512), (512, 256), (3, 128, 384)])
def test_k_major_copy_is_q_transposed(shape):
    qt, ref = _bridged(shape, seed=sum(shape))
    assert "qt" not in qt
    got = k_major(qt)
    assert got.is_contiguous() and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.swapaxes(ref["q"], -1, -2))
    assert k_major(qt) is got and qt["qt"] is got      # made once, kept
    np.testing.assert_array_equal(qt["q"].numpy(), ref["q"])   # q as it was


def test_layer_slices_the_k_major_copy():
    """A stacked weight's copy, sliced by ``_layer``, is each layer's own
    ``q`` transposed, and contiguous (the kernel's TMA reads it row by
    row)."""
    qt, _ = _bridged((3, 128, 256), seed=4)
    k_major(qt)
    for i in range(3):
        p = tw._layer({"fc1_w": qt}, i)["fc1_w"]
        assert set(p) == {"q", "s", "qt"} and p["qt"].is_contiguous()
        assert torch.equal(p["qt"], p["q"].t())


def test_encoder_with_k_major_copies_is_unchanged_on_cpu():
    """The CPU runs K2's plain version, which reads ``q``: an int8 encoder
    whose fc1/fc2 hold their K-major copies gives the same states, and the
    CPU path makes no copy of its own."""
    from nobs_whisper_torch.ops.quant import quantize_encoder_params
    from nobs_whisper_torch.utils.testing import tiny_test_config
    cfg = tiny_test_config(d=128, heads=2, n_audio_ctx=32)
    params = quantize_encoder_params(tw.init_params(2, cfg))
    mel = torch.from_numpy(
        np.random.RandomState(3).randn(1, 80, 64).astype(np.float32))
    blocks = params["encoder"]["blocks"]
    want = tw.encode(params, mel, cfg)
    assert "qt" not in blocks["fc1_w"] and "qt" not in blocks["fc2_w"]
    k_major(blocks["fc1_w"])
    k_major(blocks["fc2_w"])
    assert torch.equal(tw.encode(params, mel, cfg), want)


def _constants():
    src = open(SRC).read()
    m = re.search(r"constexpr int FC1_BN_WIDE = (\d+), FC1_BN = (\d+), "
                  r"MLP_MAX_CLUSTER = (\d+);", src)
    assert m, "fc1's constants moved in fused_mlp.cu"
    return src, tuple(int(v) for v in m.groups())


def test_fc1_constants_match_the_kernel():
    """The tile widths and the largest cluster are the source's, and the
    source chooses the plan as the wrapper does (the same conditions in
    the same order)."""
    src, consts = _constants()
    assert consts == (fm.FC1_BN_WIDE, fm.FC1_BN, fm.MLP_MAX_CLUSTER)
    body = re.search(r"inline void fc1_plan\(int block_f, int& bn, "
                     r"int& cluster\) \{(.*?)\n\}", src, re.S).group(1)
    body = " ".join(body.split())
    assert ("if (block_f % FC1_BN_WIDE == 0 && block_f / FC1_BN_WIDE <= "
            "MLP_MAX_CLUSTER) { bn = FC1_BN_WIDE; cluster = block_f / "
            "FC1_BN_WIDE; } else { bn = FC1_BN; cluster = block_f / FC1_BN "
            "<= MLP_MAX_CLUSTER ? block_f / FC1_BN : 0; }") == body
    # the cluster path's kernel for each tile width, and the two-pass one
    for inst in ("launch_fc1_cluster<FC1_BN_WIDE>",
                 "launch_fc1_cluster<FC1_BN>",
                 "launch_fc1_twopass(txq, tw1, f1, st)"):
        assert inst in src


# chunk width -> (fc1 tile width, cluster size); 0: the two-pass variant
PLAN = {128: (128, 1), 256: (128, 2), 512: (128, 4), 640: (160, 4),
        1280: (160, 8), 2048: (128, 16), 2560: (160, 16), 3072: (128, 0),
        4096: (128, 0), 5120: (128, 0)}


@pytest.mark.parametrize("block_f", sorted(PLAN))
def test_fc1_plan_per_chunk_width(block_f):
    """K2's default chunk 2560 (clusters of 16 blocks of 160 columns), K8's
    1280 (8) and K12's and the tests' widths; a chunk that no cluster of
    at most 16 tiles covers (at ffn 5120 only the whole FFN) takes the
    two-pass variant,
    whose workspace alone holds fc1's f32 (M, ffn) output."""
    bn, cluster = fm.fc1_plan(block_f)
    assert (bn, cluster) == PLAN[block_f]
    assert block_f % bn == 0 and cluster <= fm.MLP_MAX_CLUSTER
    assert cluster == 0 or cluster * bn == block_f
    ffn = next(f for f in (5120, 4096, 6144) if f % block_f == 0)
    a, amax, aq = fm.mlp_workspace(300, ffn, block_f, torch.device("cpu"))
    assert tuple(a.shape) == ((300, ffn) if cluster == 0 else (1,))
    assert a.dtype == torch.float32
    assert tuple(amax.shape) == (300, ffn // block_f)
    assert tuple(aq.shape) == (300, ffn) and aq.dtype == torch.int8


def test_c_signature_matches_the_wrapper():
    """Each of the four C entries takes 15 pointers, four ints and the
    stream, as ``fm._SIG`` declares for ctypes."""
    src = open(SRC).read()
    args = re.search(r"#define NWT_MLP_ARGS(.*?)\n#define", src, re.S).group(1)
    args = [a.strip(" \\\n") for a in args.replace("\\\n", " ").split(",")]
    kinds = ["ptr" if "*" in a else a.split()[0] for a in args]
    assert kinds == ["ptr"] * 15 + ["int"] * 4 + ["ptr"]
    for fn in fm._ENTRY.values():
        assert f'extern "C" int {fn}(NWT_MLP_ARGS)' in src
        assert len(fm._SIG[fn]) == len(kinds)
