"""Int8 weight quantization (PyTorch port of ``ops/quant.py``).

Weights keep the reference layout: a QTensor is ``{"q": int8 (..., K, N),
"s": f32 (..., 1, N)}``, per-output-channel symmetric scales. Integer
products are computed exactly: int32 (``torch._int_mm``, on either
device, where its shape rule allows), float64 for the shapes it refuses —
an f32 sum of up to 5120 products of ±127 can pass 2^24 and stop being
exact.

The reference's Pallas dequantizing matmul (``q8_matmul``) is not on the
serving path and is not ported here.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

QTensor = Dict[str, torch.Tensor]


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8: w ~= q * s, s = absmax/127.
    Works on (K, N) and stacked (L, K, N) weights (channel = last axis)."""
    w32 = w.to(torch.float32)
    absmax = torch.amax(torch.abs(w32), dim=-2, keepdim=True)
    s = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "s" in w


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
