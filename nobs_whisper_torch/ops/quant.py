"""Int8 weight quantization (PyTorch port of ``ops/quant.py``).

Weights keep the reference layout: a QTensor is ``{"q": int8 (..., K, N),
"s": f32 (..., 1, N)}``, per-output-channel symmetric scales, and on the
card, once an int8 ``wgmma`` kernel (K1, K2, K8, K10, K11, K12) has read
it, ``"qt"``: ``q``'s K-major copy (:func:`k_major`). Integer products are computed exactly:
int32 (``torch._int_mm``, on either device, where its shape rule allows),
float64 for the shapes it refuses — an f32 sum of up to 5120 products of
±127 can pass 2^24 and stop being exact.

K6, the reference's Pallas dequantizing matmul (:func:`q8_matmul`, opt-in
behind ``NWT_Q8_KERNEL_MIN_BYTES``; gate in ``models/whisper.py::_dense``),
is CUDA in ``csrc/q8_matmul.cu``, whose source note says what bounds it on
an H100: one kernel for the decode rows (M <= 16, bound by the weight's
bytes) and one for the prefill rows (16 < M <= 256). Both split K over a
thread-block cluster and sum the partials in a fixed order, so every
output element is written once and two calls give the same bits; the
output is allocated uninitialised. The wrapper launches the kernel for a
CUDA tensor (or raises) and runs :func:`q8_matmul_plain` for a CPU
tensor; ``k6_launch_count`` counts kernel launches only, and
``k6_decode_launch_count`` those with M <= 16.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Tuple, Union

import torch

from . import _build

QTensor = Dict[str, torch.Tensor]

k6_launch_count = 0
k6_decode_launch_count = 0      # launches with M <= K6_DECODE_ROWS
K6_DECODE_ROWS = 16             # csrc/q8_matmul.cu's DECODE_ROWS
# csrc/q8_decode.cuh's decode kernel: columns a block, weight rows a slab,
# K rows of x a block stages, blocks a cluster, blocks an SM the split
# aims at (k6_split)
K6_DBN, K6_DBK, K6_DXK_MAX, K6_MAX_CLUSTER, K6_SPLIT_TARGET = (
    128, 32, 2048, 16, 1)

_Q8_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_Q8_SIG = {"nwt_q8_matmul_bf16": _Q8_ARGS, "nwt_q8_matmul_f32": _Q8_ARGS}
_Q8_ENTRY = {torch.bfloat16: "nwt_q8_matmul_bf16",
             torch.float32: "nwt_q8_matmul_f32"}


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8: w ~= q * s, s = absmax/127.
    Works on (K, N) and stacked (L, K, N) weights (channel = last axis).
    ``q`` is row-major whatever the strides of ``w`` (the logit projection
    quantizes a transposed view)."""
    w32 = w.to(torch.float32)
    absmax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q.contiguous(), "s": s.to(torch.float32)}


def k_major(qt: QTensor) -> torch.Tensor:
    """``qt["q"]`` (..., K, N) as its transposed copy (..., N, K),
    row-major: the K-major layout in which 8-bit ``wgmma`` reads a weight
    (K2's kernels, ``csrc/fused_mlp.cu``; the projections of K10, K11, K1
    and K12, ``csrc/proj_wgmma.cuh``). Made at the first call and kept
    in the QTensor under ``"qt"`` beside ``"q"``, so that it is made once
    per weight, never per call; ``"q"`` stays what the plain versions and
    the weight bridge read."""
    qt_ = qt.get("qt")
    if qt_ is None:
        qt_ = qt["qt"] = qt["q"].transpose(-1, -2).contiguous()
    return qt_


def dequantize_int8(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt["q"].to(torch.float32) * qt["s"]).to(dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


# ---------------------------------------------------------------------------
# K6: x (M, K) bf16/f32 @ dequant(w) -> (M, N) f32
# ---------------------------------------------------------------------------

def k6_split(k: int, n: int, sms: int) -> Tuple[int, int]:
    """(split, rows a block) of K6's decode kernel for a (K, N) weight on a
    card of ``sms`` multiprocessors, as ``csrc/q8_decode.cuh::split_k``
    chooses them: one 128-column tile a cluster, its K range split until
    the grid has about ``K6_SPLIT_TARGET`` blocks an SM, at most
    ``K6_MAX_CLUSTER`` blocks and ``K6_DXK_MAX`` rows a block, in whole
    32-row slabs."""
    tiles, slabs = -(-n // K6_DBN), -(-k // K6_DBK)
    want = -(-(K6_SPLIT_TARGET * sms) // tiles)
    want = max(1, min(want, K6_MAX_CLUSTER, slabs))
    per = min(-(-slabs // want), K6_DXK_MAX // K6_DBK)
    return -(-slabs // per), per * K6_DBK


def q8_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """Plain PyTorch K6 with the Pallas kernel's numerics
    (``_q8_matmul_kernel``): w = bf16(bf16(q) * bf16(s)), x rounded to
    bf16, products exact in f32 and summed in f32. (M, N) f32."""
    w = qt["q"].to(torch.bfloat16) * qt["s"].to(torch.bfloat16)
    return x.to(torch.bfloat16).float() @ w.float()


def q8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K6: (M, K) bf16 or f32 @ int8 (K, N) with (1, N) f32 per-channel
    scales -> (M, N) f32, each weight tile dequantized to bf16 on chip.
    The reference's VMEM tiles ``block_m``/``block_n`` do not change the
    result and have no counterpart here."""
    _build.no_autograd("K6", x, qt)
    m, k = x.shape
    k2, n = qt["q"].shape
    assert k == k2, (k, k2)
    if x.device.type == "cpu":
        return q8_matmul_plain(x, qt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if (x.dtype not in _Q8_ENTRY or qt["q"].dtype != torch.int8
            or qt["s"].numel() != n):
        raise ValueError(f"K6 takes bf16 or f32 x and an int8 (K, N) weight "
                         f"with N scales; got {x.dtype}, "
                         f"{qt['q'].dtype}, {qt['s'].numel()} scales")
    fn = getattr(_build.load("q8_matmul", _Q8_SIG), _Q8_ENTRY[x.dtype])
    x = x.contiguous()
    w = qt["q"].contiguous()
    s = qt["s"]
    if s.dtype != torch.float32 or not s.is_contiguous():
        s = s.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    # the raw stream query: torch.cuda.current_stream() costs ~5 us a call,
    # and the decode loop's host time is its cost
    err = fn(x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), m, k,
             n, torch._C._cuda_getCurrentRawStream(x.device.index))
    _build.check(err, "q8_matmul")
    _build.count(globals(), "k6_launch_count")
    if m <= K6_DECODE_ROWS:
        _build.count(globals(), "k6_decode_launch_count")
    return out


def dense(x: torch.Tensor, w: Union[torch.Tensor, QTensor],
          use_kernel: bool = False) -> torch.Tensor:
    """The reference's linear dispatch for kernel A/B checks: a plain
    weight uses ``@``; a quantized one dequantizes in x.dtype, or runs K6
    with ``use_kernel`` on 2-D operands. The production dispatcher is
    ``models/whisper.py::_dense``, which adds the bias and the gate."""
    if not is_quantized(w):
        return x @ w
    if use_kernel and x.ndim == 2 and w["q"].ndim == 2:
        return q8_matmul(x, w).to(x.dtype)
    return x @ (w["q"].to(x.dtype) * w["s"].to(x.dtype))


def int8_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) float32, each sum exact
    before its single round to f32 (the reference's int32 accumulator
    followed by ``astype(f32)``)."""
    lead = a.shape[:-1]
    a2 = a.reshape(-1, a.shape[-1])
    m, k = a2.shape
    n = b.shape[-1]
    if m > 16 and k % 8 == 0 and n % 8 == 0:
        y = torch._int_mm(a2.contiguous(), b.contiguous())
    else:
        y = a2.to(torch.float64) @ b.to(torch.float64)
    return y.to(torch.float32).reshape(*lead, n)


def quantize_rows(h: torch.Tensor, floor: float = 1e-6):
    """Per-row dynamic int8 quantization as the Pallas kernels do it:
    s = max(absmax, 1e-6) / 127, q = clip(round_half_even(h / s)).
    ``h`` f32 (..., K) -> (q int8, s f32 (..., 1))."""
    s = torch.clamp(torch.amax(torch.abs(h), dim=-1, keepdim=True),
                    min=floor) / 127.0
    q = torch.clamp(torch.round(h / s), -127, 127).to(torch.int8)
    return q, s


def ln_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
           eps: float = 1e-5) -> torch.Tensor:
    """The Pallas kernels' LayerNorm: f32 mean, biased variance,
    (x - mean) * rsqrt(var + eps) * g + b, result in f32."""
    xf = x.to(torch.float32)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    h = (xf - mean) * torch.rsqrt(var + eps)
    return h * g.to(torch.float32) + b.to(torch.float32)


_QUANT_KEYS = {
    "q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w",
    "xq_w", "xk_w", "xv_w", "xo_w",
}


def dense_int8_dynamic(x: torch.Tensor, w: QTensor, b=None) -> torch.Tensor:
    """Dynamic-activation int8 matmul (XLA in the reference, plain torch
    here). Its own row-scale floor: s_x = max(absmax/127, 1e-8)."""
    xf = x.to(torch.float32)
    s_x = torch.clamp(torch.amax(torch.abs(xf), dim=-1, keepdim=True)
                      / 127.0, min=1e-8)
    x_q = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    y = int8_matmul_exact(x_q, w["q"]) * s_x * w["s"]
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


_ENC_QUANT_KEYS = {"q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w"}


def quantize_encoder_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the encoder's linear weights (conv stem, norms and
    positional tables stay fp)."""
    out = dict(params)
    enc = dict(params["encoder"])
    blocks = dict(enc["blocks"])
    for key in list(blocks.keys()):
        if key in _ENC_QUANT_KEYS:
            blocks[key] = quantize_int8(blocks[key])
    enc["blocks"] = blocks
    out["encoder"] = enc
    return out


def fuse_qkv(params: Dict[str, Any]) -> Dict[str, Any]:
    """Merge the decoder's self-attention q/k/v projections into one
    (d, 3d) matmul per layer (k has no bias; a zero slot keeps the fused
    bias layout uniform). Works on plain or int8-quantized trees."""
    out = dict(params)
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])

    def cat(ws, dim=-1):
        if is_quantized(ws[0]):
            return {"q": torch.cat([w["q"] for w in ws], dim=dim),
                    "s": torch.cat([w["s"] for w in ws], dim=dim)}
        return torch.cat(ws, dim=dim)

    blocks["qkv_w"] = cat([blocks.pop("q_w"), blocks.pop("k_w"),
                           blocks.pop("v_w")])
    q_b = blocks.pop("q_b")
    v_b = blocks.pop("v_b")
    blocks["qkv_b"] = torch.cat([q_b, torch.zeros_like(q_b), v_b], dim=-1)
    dec["blocks"] = blocks
    out["decoder"] = dec
    return out


def quantize_decoder_params(params: Dict[str, Any],
                            quantize_tok_emb: bool = True) -> Dict[str, Any]:
    """Quantize the decoder's linear weights; tok_emb doubles as the logit
    projection and is quantized (transposed, (d, V)) by default."""
    out = dict(params)
    dec = dict(params["decoder"])
    blocks = dict(dec["blocks"])
    for key in list(blocks.keys()):
        if key in _QUANT_KEYS:
            blocks[key] = quantize_int8(blocks[key])
    dec["blocks"] = blocks
    if quantize_tok_emb:
        dec["tok_emb_q"] = quantize_int8(dec["tok_emb"].T)  # (d, V)
    out["decoder"] = dec
    return out
