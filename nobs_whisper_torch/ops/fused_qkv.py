"""K10 and K11: the int8 encoder's attention projections under
``NWT_INT8_QKV`` (port of ``ops/fused_qkv.py``).

* K10 :func:`encoder_qkv_int8` (``encoder_qkv_int8``): LN, per-row int8
  quantization, the three (d, d) int8 projections with per-channel scales
  and the q/v biases, outputs in x's dtype (whisper.py:448-458);
* K11 :func:`residual_o_int8` (``residual_o_int8``): x + o_proj(a), a
  quantized per row without LN (whisper.py:518-525).

Both take bf16 or f32 activations: the reference's gate tests no dtype.
The CUDA kernels live in ``csrc/fused_qkv.cu``; its source note says what
bounds them on an H100 and how the design answers that: a row
quantization pass, then one int8 ``wgmma`` GEMM fed by TMA, which reads
each weight as its K-major copy (``ops/quant.py::k_major``, made once per
QTensor and kept beside ``q``). Each wrapper launches its kernel for a
CUDA tensor (or raises) and runs its ``*_plain`` version for a CPU
tensor. ``k10_launch_count`` and ``k11_launch_count`` count kernel
launches of both activation types, ``*_f32`` the f32 ones alone.
:func:`qkv_reference` and :func:`residual_o_reference` are the XLA
path's numerics (``dense_int8_dynamic``), which the kernels replace.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .quant import (dense_int8_dynamic, int8_matmul_exact, k_major, ln_f32,
                    quantize_rows)

k10_launch_count = 0
k10_launch_count_f32 = 0
k11_launch_count = 0
k11_launch_count_f32 = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_QKV_ARGS = [_P] * 16 + [_I] * 2 + [_P]
_RES_O_ARGS = [_P] * 8 + [_I] * 2 + [_P]
_ENTRY = {("K10", torch.bfloat16): "nwt_encoder_qkv_int8",
          ("K10", torch.float32): "nwt_encoder_qkv_int8_f32",
          ("K11", torch.bfloat16): "nwt_residual_o_int8",
          ("K11", torch.float32): "nwt_residual_o_int8_f32"}
_SIG = {fn: _QKV_ARGS if key == "K10" else _RES_O_ARGS
        for (key, _), fn in _ENTRY.items()}
def qkv_workspace(m, d, dev):
    """Both kernels' workspace: the int8 rows (m, d) and their scales."""
    return (torch.empty((m, d), dtype=torch.int8, device=dev),
            torch.empty((m,), dtype=torch.float32, device=dev))


def _proj(hq, sx, w, bias=None):
    """(acc * s_row) * s_col (+ bias) in f32, the kernels' epilogue."""
    y = int8_matmul_exact(hq, w["q"]) * sx * w["s"].reshape(1, -1).float()
    return y if bias is None else y + bias.to(torch.float32)


def encoder_qkv_int8_plain(x, ln_g, ln_b, wq, q_b, wk, wv, v_b):
    """Plain PyTorch K10 with the Pallas kernel's numerics: LN in f32, row
    scale max(absmax, 1e-6)/127, exact int8 products; each output rounded
    once to x.dtype."""
    hq, sx = quantize_rows(ln_f32(x, ln_g, ln_b))
    return (_proj(hq, sx, wq, q_b).to(x.dtype),
            _proj(hq, sx, wk).to(x.dtype),
            _proj(hq, sx, wv, v_b).to(x.dtype))


def residual_o_int8_plain(x, a, wo, o_b):
    """Plain PyTorch K11: a quantized per row (floor 1e-6), the o
    projection and its bias in f32, added to f32(x), rounded to x.dtype."""
    aq, sa = quantize_rows(a.to(torch.float32))
    return (x.to(torch.float32) + _proj(aq, sa, wo, o_b)).to(x.dtype)


def qkv_reference(x, ln_g, ln_b, wq, q_b, wk, wv, v_b):
    """The XLA dynamic-int8 path (the shipping encoder's numerics):
    LN rounded to x.dtype, then ``dense_int8_dynamic`` per projection."""
    h = ln_f32(x, ln_g, ln_b).to(x.dtype)
    return (dense_int8_dynamic(h, wq, q_b), dense_int8_dynamic(h, wk),
            dense_int8_dynamic(h, wv, v_b))


def residual_o_reference(x, a, wo, o_b):
    return (x.to(torch.float32)
            + dense_int8_dynamic(a, wo, o_b).to(torch.float32)).to(x.dtype)


def _checks(key, x, weights):
    m, d = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (key, x.dtype) not in _ENTRY or d % 128:
        raise ValueError(f"{key} takes bf16 or f32 (M, d) rows with "
                         f"d % 128 == 0; got {x.dtype} d={d}")
    for w in weights:
        if w["q"].dtype != torch.int8 or tuple(w["q"].shape) != (d, d):
            raise ValueError(f"{key}: weights must be (d, d) int8 QTensors")
    from . import _build
    return _build.load("fused_qkv", _SIG)


def _f32(z, dev):
    """``z`` as contiguous f32 on ``dev``: ``z`` itself where it is one
    already (the wrapper's host time is most of a call's at these
    sizes)."""
    if z.dtype == torch.float32 and z.device == dev and z.is_contiguous():
        return z
    return z.to(device=dev, dtype=torch.float32).contiguous()


def encoder_qkv_int8(x, ln_g, ln_b, wq, q_b, wk, wv, v_b):
    """K10. ``x``: (M, d) bf16 or f32 rows; ``wq``/``wk``/``wv``: int8
    QTensors ({"q": (d, d) int8, "s": (1, d) f32}, (d_in, d_out) layout;
    the kernel reads their K-major copies, made at the first launch);
    ``q_b``/``v_b``: (d,) biases (k has none). Returns (q, k, v), each
    (M, d) in x.dtype. The reference's row tile ``block_m``
    (``NWT_QKV_BM``) does not change the result and has no counterpart
    here."""
    global k10_launch_count, k10_launch_count_f32
    if x.device.type == "cpu":
        return encoder_qkv_int8_plain(x, ln_g, ln_b, wq, q_b, wk, wv, v_b)
    lib = _checks("K10", x, (wq, wk, wv))
    m, d = x.shape
    dev = x.device
    # every converted tensor stays in a name until the launch has returned
    x = x.contiguous()
    w = [k_major(z) for z in (wq, wk, wv)]
    s = [_f32(z["s"], dev) for z in (wq, wk, wv)]
    g, be, bq, bv = (_f32(z, dev) for z in (ln_g, ln_b, q_b, v_b))
    q, k, v = (torch.empty_like(x) for _ in range(3))
    xq, sx = qkv_workspace(m, d, dev)
    fn = _ENTRY["K10", x.dtype]
    err = getattr(lib, fn)(*(z.data_ptr() for z in (
        x, g, be, w[0], s[0], bq, w[1], s[1], w[2], s[2], bv, q, k, v, xq,
        sx)), m, d, torch._C._cuda_getCurrentRawStream(dev.index))
    from . import _build
    _build.check(err, fn)
    with _build.COUNT_LOCK:
        k10_launch_count += 1
        k10_launch_count_f32 += int(x.dtype == torch.float32)
    return q, k, v


def residual_o_int8(x, a, wo, o_b):
    """K11: x + o_proj(a). ``x``, ``a``: (M, d) of one dtype, bf16 or f32;
    ``wo``: int8 QTensor (d, d); ``o_b``: (d,). Returns (M, d) in
    x.dtype."""
    global k11_launch_count, k11_launch_count_f32
    if x.device.type == "cpu":
        return residual_o_int8_plain(x, a, wo, o_b)
    lib = _checks("K11", x, (wo,))
    if a.shape != x.shape or a.dtype != x.dtype or a.device != x.device:
        raise ValueError("K11 takes x and a of one shape, dtype and device")
    m, d = x.shape
    dev = x.device
    x, a = x.contiguous(), a.contiguous()
    s, b = _f32(wo["s"], dev), _f32(o_b, dev)
    w = k_major(wo)
    out = torch.empty_like(x)
    aq, sa = qkv_workspace(m, d, dev)
    fn = _ENTRY["K11", x.dtype]
    err = getattr(lib, fn)(*(z.data_ptr() for z in (
        x, a, w, s, b, out, aq, sa)), m, d,
        torch._C._cuda_getCurrentRawStream(dev.index))
    from . import _build
    _build.check(err, fn)
    with _build.COUNT_LOCK:
        k11_launch_count += 1
        k11_launch_count_f32 += int(x.dtype == torch.float32)
    return out
