"""What the CPU can check of K5's and K7's plans on Hopper: the Python
mirrors of how the CUDA sources cut the work, tied to the sources'
constants and rules.

* K5 (``csrc/cross_attention_decode.cu``, the int8 cross-attention decode
  step) runs a thread-block cluster of C blocks per (batch row, head), each
  block a slice of the encoder positions. ``ops/attention_pallas.py::
  k5_plan`` is the kernel's choice of C and of the slice: every position
  falls in exactly one slice, slices are multiples of 16 positions, C is a
  power of two no larger than 16, and a block's shared memory holds its
  slice.
* K7 (``csrc/fused_mlp_q8.cu``, the decoder's fused int8 MLP) is two
  launches of K6's decode kernel (``csrc/q8_decode.cuh``) for each group
  of up to 32 rows, which the header's ``split_k`` splits as it splits K6
  at the same shape (``ops/quant.py::k6_split`` is its mirror).

The kernels themselves run on the card (``tests/test_torch_kernels_gpu.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from nobs_whisper_torch.ops import attention_pallas as ap
from nobs_whisper_torch.ops import fused_mlp as fm
from nobs_whisper_torch.ops import quant as qt

CSRC = os.path.join(os.path.dirname(ap.__file__), os.pardir, "csrc")
SMS = 132   # an H100 SXM's multiprocessors


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _flat(name):
    return " ".join(_source(name).split())


def _constant(src, name):
    found = re.findall(rf"constexpr int {name} = (\d+);", src)
    assert len(found) == 1, f"{name}: {found}"
    return int(found[0])


def test_k5_constants_match_the_kernel():
    """The Python plan's constants are the kernel's, and the checkout
    builds the plan's own cluster size, not an ablation's fixed one."""
    src = _source("cross_attention_decode.cu")
    assert {n: _constant(src, n) for n in (
        "K5_THREADS", "K5_MAX_C", "K5_STEP", "K5_TARGET", "K5_RESIDENT",
        "K5_SMEM_MAX", "K5_BOX", "K5_MAX_BOX")} == {
        "K5_THREADS": ap.K5_THREADS, "K5_MAX_C": ap.K5_MAX_C,
        "K5_STEP": ap.K5_STEP, "K5_TARGET": ap.K5_TARGET,
        "K5_RESIDENT": ap.K5_RESIDENT, "K5_SMEM_MAX": ap.K5_SMEM_MAX,
        "K5_BOX": ap.K5_BOX, "K5_MAX_BOX": ap.K5_MAX_BOX}
    assert _constant(src, "K5_FORCE_C") == 0
    assert ap.K5_MAX_C == 16 and ap.K5_SMEM_MAX == 232448


def test_k5_rule_and_shared_memory_match_the_kernel():
    """``k5_plan``'s loop and ``k5_smem``'s sizes are the ones the kernel's
    host code and shared-memory layout use."""
    src = _flat("cross_attention_decode.cu")
    for rule in (
            "return 8 * (K5_MAX_BOX + 4) + 4 * K5_WARPS * dh + 4 * K5_PK + "
            "4 * dh + 4 * 2 * K5_MAX_C + 4 * dh + 4 * K5_WARPS;",
            "(size_t)k5_head_aligned(dh) + (size_t)dh * k5_boxes(s) * "
            "k5_box_width(s) + (size_t)8 * s;",
            "return (s / K5_STEP + K5_BOX / K5_STEP - 1) / (K5_BOX / K5_STEP);",
            "return (s / K5_STEP + k5_boxes(s) - 1) / k5_boxes(s) * K5_STEP;",
            "while (c < K5_MAX_C && 2 * c <= chunks && ((long long)c * bh < "
            "(long long)K5_TARGET * sms || k5_smem(dh, slice(c)) > "
            "(size_t)K5_SMEM_MAX / K5_RESIDENT)) c *= 2;",
            "auto slice = [&](int c) { return (chunks + c - 1) / c * "
            "K5_STEP; };",
            "return k5_smem(dh, S) <= (size_t)K5_SMEM_MAX && k5_boxes(S) <= "
            "K5_MAX_BOX ? c : 0;",
            "cfg.gridDim = dim3(c, BH);"):
        assert rule in src, rule
    # the head's 128-byte alignment
    assert "(k5_head(dh) + 127) & ~127" in src
    assert "constexpr int K5_PK = 4 * K5_THREADS;" in src
    assert ap.K5_PK == 4 * ap.K5_THREADS
    assert ap.k5_smem(64, 192) == 7040 + 64 * 192 + 8 * 192


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("tp", [16, 128, 208, 384, 768, 1504, 1536, 3072])
@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 32])
def test_k5_plan_covers_every_position_once(b, tp, dh):
    """Every position of Tp lies in exactly one block's slice; slices are
    multiples of 16; C is a power of two up to 16 and at most the
    16-position chunks; a block's shared memory holds its
    slice; and C stops doubling only once the grid has a block an SM and
    the slice leaves room for two blocks an SM (or at its limits)."""
    bh = 20 * b
    c, s = ap.k5_plan(bh, tp, SMS, dh)
    assert c in (1, 2, 4, 8, 16)
    assert s % ap.K5_STEP == 0 and s > 0
    covered = np.concatenate([np.arange(r * s, min(tp, (r + 1) * s))
                              for r in range(c)])
    assert np.array_equal(covered, np.arange(tp))
    assert c <= max(1, tp // 16)
    assert ap.k5_smem(dh, s) <= ap.K5_SMEM_MAX
    nb, bw = ap.k5_boxes(s)
    assert nb <= ap.K5_MAX_BOX and bw <= ap.K5_BOX and bw % 16 == 0
    assert (nb - 1) * bw < s <= nb * bw
    at_limit = c == ap.K5_MAX_C or 2 * c > tp // 16
    if not at_limit:
        assert c * bh >= ap.K5_TARGET * SMS
        assert ap.k5_smem(dh, s) <= ap.K5_SMEM_MAX // ap.K5_RESIDENT


def test_k5_plan_at_turbo():
    """large-v3-turbo (20 heads of 64, Tp 1536): B = 1 takes a cluster of 8
    (160 blocks of 192 positions), B = 8 a cluster of 2 (768 positions, two
    blocks an SM); an odd number of 16-position chunks (Tp = 208, 13)
    leaves the last slice short and the cluster's last block empty."""
    assert ap.k5_plan(20, 1536, SMS) == (8, 192)
    assert ap.k5_plan(160, 1536, SMS) == (2, 768)
    assert ap.k5_plan(320, 1536, SMS) == (2, 768)
    c, s = ap.k5_plan(8, 208, SMS)
    assert (c, s) == (8, 32) and (c - 1) * s >= 208 > (c - 2) * s


def test_k5_plan_refuses_what_no_block_holds():
    """A Tp whose sixteenth part does not fit a block is refused (C = 0),
    at any SM count; the turbo shapes are far inside."""
    for sms in (1, SMS):
        assert ap.k5_plan(20, 16 * 1024 * 16, sms, 128)[0] == 0
        assert ap.k5_plan(20, 1536, sms, 128)[0] > 0


def test_k5_plain_gives_uniform_weights_when_all_masked():
    """Every scale zero: the plain version's scores are all -1e30, so p is
    uniform, 1 / Tp, and out = bf16(vs / Tp) @ vq, which the kernel must
    give too (an all-masked slice has max -1e30 in every block)."""
    rng = np.random.RandomState(0)
    b, h, tp, dh = 1, 2, 64, 32
    q = torch.from_numpy(rng.randn(b, h, 1, dh).astype(np.float32))
    kq = {"q": torch.from_numpy(rng.randint(-127, 128, (b, h, dh, tp))
                                .astype(np.int8)),
          "s": torch.zeros(b, h, tp)}
    vq = {"q": torch.from_numpy(rng.randint(-127, 128, (b, h, tp, dh))
                                .astype(np.int8)),
          "s": torch.from_numpy(rng.rand(b, h, tp).astype(np.float32))}
    got = ap.cross_attention_decode_q8_plain(q, kq, vq)
    pv = (vq["s"] / tp).to(torch.bfloat16).float()
    want = pv[:, :, None, :] @ vq["q"].float()
    assert torch.equal(got, want)


def test_k6_split_constants_match_the_kernel():
    """``k6_split``'s constants are ``csrc/q8_decode.cuh``'s, and the rule
    is its ``split_k``'s."""
    src = _source("q8_decode.cuh")
    assert (_constant(src, "DBN"), _constant(src, "DBK"),
            _constant(src, "DXK_MAX"), _constant(src, "DMAX_CLUSTER"),
            _constant(src, "DSPLIT_TARGET")) == (
        qt.K6_DBN, qt.K6_DBK, qt.K6_DXK_MAX, qt.K6_MAX_CLUSTER,
        qt.K6_SPLIT_TARGET)
    flat = _flat("q8_decode.cuh")
    for rule in (
            "int want = (DSPLIT_TARGET * sm_count() + tiles - 1) / tiles;",
            "want = std::max(1, std::min(want, std::min(DMAX_CLUSTER, "
            "slabs)));",
            "per = std::min((slabs + want - 1) / want, max_slabs);",
            "split = (slabs + per - 1) / per;",
            "split_k(K, N, DBK, DXK_MAX / DBK, split, per);"):
        assert rule in flat, rule


def test_k6_split_at_the_decoder_shapes():
    """At turbo's decoder on 132 SMs: fc1 (1280 x 5120) 4 blocks of 320
    rows, fc2 (5120 x 1280) 14 of 384, the logits (1280 x 51,866) one
    block a tile."""
    assert qt.k6_split(1280, 5120, SMS) == (4, 320)
    assert qt.k6_split(5120, 1280, SMS) == (14, 384)
    assert qt.k6_split(1280, 51866, SMS) == (1, 1280)


def test_k7_runs_on_the_shared_decode_kernel():
    """``fused_mlp_q8.cu`` has no kernel of its own: it includes the
    decode header and launches its kernel twice, fc1 with the LayerNorm
    prologue and fc2 after it; its row group is K6's decode rows; K6
    launches the same kernel."""
    k7 = _source("fused_mlp_q8.cu")
    assert '#include "q8_decode.cuh"' in k7 and "__global__" not in k7
    assert len(re.findall(r"launch_decode<", k7)) == 2
    assert "RowsLayerNorm{g, be}" in k7 and "BiasGeluBf16{b1, act}" in k7
    assert "BiasResidual<T>{b2, x, out}" in k7
    assert _constant(k7, "K7_GROUP") == fm.K7_GROUP == qt.K6_DECODE_ROWS
    k6 = _source("q8_matmul.cu")
    assert '#include "q8_decode.cuh"' in k6
    assert "launch_decode<T, 1, true>(x, w, s, M, K, N, rows, store, st)" in k6
    assert "q8_decode_kernel" not in k6.split("#include")[-1].split(
        "q8_prefill_kernel")[0]


def test_k7_entry_points_match_the_wrapper():
    """The wrapper's signatures are the C entries': two MLP entries of 11
    pointers, 3 ints and the stream, and the PDL switch."""
    k7 = _flat("fused_mlp_q8.cu")
    assert "extern \"C\" int nwt_fused_mlp_q8_set_pdl(int on)" in k7
    for name in ("nwt_fused_mlp_q8", "nwt_fused_mlp_q8_f32"):
        assert f"NWT_MLP_Q8_ENTRY({name}," in k7
        assert len(fm._K7_SIG[name]) == 15
    assert fm._K7_SIG["nwt_fused_mlp_q8_set_pdl"] == [fm.ctypes.c_int]
