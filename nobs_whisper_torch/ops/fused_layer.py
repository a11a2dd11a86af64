"""K12: one whole int8 encoder layer (port of ``ops/fused_layer.py``).

:func:`encoder_layer_fused` (``encoder_layer_fused``, ``NWT_ATTN_FUSED=3``,
whisper.py:395-413) computes exactly K1 with the o projection and the
residual fused (the int8 scores and PV variants included), the result
rounded to bf16 (fused_layer.py:129), then K2's resident MLP with K12's
own fc2-input chunk (``NWT_MLP_BF`` or 1280 at the call site, whatever
``NWT_MLP_CHUNKED`` says).

The CUDA entry point ``nwt_encoder_layer_fused`` (``csrc/fused_layer.cu``)
launches the two halves' kernels in sequence; its source note says what
the TPU kernel keeps on chip that this version sends through device
memory. The wrapper launches it for a CUDA tensor (or raises) and runs
:func:`encoder_layer_fused_plain` for a CPU tensor. ``launch_count``
counts launches of the default variant, ``variant_launch_count`` the int8
ones by :func:`encoder_attention.variant` name ("K12-i8s-i8pv", ...).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from . import encoder_attention as ea
from . import fused_mlp as fm
from .quant import k_major

launch_count = 0
variant_launch_count: collections.Counter = collections.Counter()

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"nwt_encoder_layer_fused":
        [_P] * 40 + [_I] * 6 + [ctypes.c_float, _I, _P]}


def encoder_layer_fused_plain(x, ln1_g, ln1_b, wq, bq, wk, wv, bv, wo, bo,
                              ln2_g, ln2_b, fc1, fc1_b, fc2, fc2_b,
                              n_real: int, sm_scale: float, n_head: int,
                              block_f: int = 1280, int8_scores: bool = False,
                              int8_pv: bool = False) -> torch.Tensor:
    """Plain PyTorch K12: plain K1 with fused o (bf16 out), then plain K2
    at ``block_f`` (resolved as the reference does). x: (B, T, d) bf16."""
    b, t, d = x.shape
    x2 = ea.fused_qkv_plain(
        x, ln1_g, ln1_b, wq, bq, wk, wv, bv, n_real, sm_scale, n_head,
        int8_scores, int8_pv, wo, bo)
    return fm.mlp_int8_plain(x2.reshape(b * t, d), ln2_g, ln2_b, fc1, fc1_b,
                             fc2, fc2_b, block_f).reshape(b, t, d)


def encoder_layer_fused(x, ln1_g, ln1_b, wq, bq, wk, wv, bv, wo, bo,
                        ln2_g, ln2_b, fc1, fc1_b, fc2, fc2_b,
                        n_real: int, sm_scale: float, n_head: int,
                        block_f: int = 1280, int8_scores: bool = False,
                        int8_pv: bool = False) -> torch.Tensor:
    """One whole encoder layer. ``x``: (B, T, d) residual stream, T a
    multiple of 64 on the card (keys >= ``n_real`` masked); all linear
    weights int8 QTensors ((d_in, d_out) layout with (1, d_out) f32
    scales; the kernels read every one as its K-major copy, made at the
    first launch and kept in the QTensor); ``block_f``: the fc2-input
    requantization chunk. Returns (B, T, d) in x.dtype."""
    global launch_count
    _build.no_autograd("K12", x, ln1_g, ln1_b, wq, bq, wk, wv, bv, wo, bo,
                       ln2_g, ln2_b, fc1, fc1_b, fc2, fc2_b)
    b, t, d = x.shape
    assert n_head % 2 == 0 and d % 128 == 0 and 2 * (d // n_head) == 128, \
        (d, n_head)
    if x.device.type == "cpu":
        return encoder_layer_fused_plain(
            x, ln1_g, ln1_b, wq, bq, wk, wv, bv, wo, bo, ln2_g, ln2_b,
            fc1, fc1_b, fc2, fc2_b, n_real, sm_scale, n_head, block_f,
            int8_scores, int8_pv)
    ops = ea.fused_qkv_operands(x, ln1_g, ln1_b, wq, bq, wk, wv, bv, n_real,
                                n_head, int8_scores, int8_pv, wo, bo)
    ffn = fc1["q"].shape[-1]
    block_f = fm.resolve_block_f(block_f, ffn)
    if ffn % 128 or block_f % 128:
        raise ValueError(f"kernel takes an FFN width and chunk that are "
                         f"multiples of 128, got ffn={ffn} block_f={block_f}")
    if (fc1["q"].dtype != torch.int8 or fc2["q"].dtype != torch.int8
            or tuple(fc1["q"].shape) != (d, ffn)
            or tuple(fc2["q"].shape) != (ffn, d)):
        raise ValueError("fc1/fc2 must be (d, ffn)/(ffn, d) int8 QTensors")
    dev = x.device
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    m = b * t
    # K2's operands: the weights K-major (made once per QTensor), then its
    # workspace (a, amax, aq) and the layer's output
    mlp = [f32(ln2_g), f32(ln2_b), k_major(fc1),
           f32(fc1["s"]).reshape(ffn), f32(fc1_b), k_major(fc2),
           f32(fc2["s"]).reshape(d), f32(fc2_b),
           *fm.mlp_workspace(m, ffn, block_f, dev), torch.empty_like(ops[0])]
    lib = _build.load("fused_layer", _SIG)
    err = lib.nwt_encoder_layer_fused(
        *(ctypes.c_void_p(z.data_ptr()) for z in ops + mlp),
        b, t, d, int(n_real), ffn, block_f, ctypes.c_float(sm_scale),
        ea.variant_flags(int8_scores, int8_pv, True),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "encoder_layer_fused")
    name = ea.variant("K12", False, int8_scores, int8_pv)
    if name == "K12":
        with _build.COUNT_LOCK:
            launch_count += 1
    else:
        with _build.COUNT_LOCK:
            variant_launch_count[name] += 1
    return mlp[-1]
