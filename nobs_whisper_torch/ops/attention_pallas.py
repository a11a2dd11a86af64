"""Decoder cross-attention on the packed (Dh, T) K layout.

Port of the two XLA functions of ``ops/attention_pallas.py`` that the
serving decode loop runs: :func:`pack_cross_kv_bf16` (:138) and
:func:`cross_attention_kt_xla` (:210). Both are plain torch. The decode-step
Pallas kernels of that module (K4 ``cross_attention_decode_bf16``, K5
``cross_attention_decode_q8``) are opt-in in the reference and not ported
in this slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_cross_kv_bf16(
    cross_kv: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(xk, xv) fp (L, B, H, T, Dh) -> bf16 with K pre-transposed to
    (L, B, H, Dh, Tp) and V (L, B, H, Tp, Dh), T zero-padded to a 128
    multiple (padded positions are masked by index)."""
    xk, xv = cross_kv
    t = xk.shape[-2]
    t_pad = _round_up(t, 128)
    kT = xk.to(torch.bfloat16).transpose(-1, -2)
    kT = torch.nn.functional.pad(kT, (0, t_pad - t)).contiguous()
    v = torch.nn.functional.pad(xv.to(torch.bfloat16),
                                (0, 0, 0, t_pad - t)).contiguous()
    return {"kT": kT}, {"v": v}


def cross_attention_kt_xla(q: torch.Tensor, packed, t_real: int
                           ) -> torch.Tensor:
    """Cross-attention on the packed layout: bf16 operands, f32 scores and
    f32 output (the reference's ``preferred_element_type=f32``: products
    of bf16 values are exact in f32, so the matmuls run on f32 copies).
    q (B, H, S, Dh) -> (B, H, S, Dh) f32."""
    kT = packed["kT"]                                  # (B, H, Dh, Tp)
    v = packed["v"]                                    # (B, H, Tp, Dh)
    dh = q.shape[-1]
    scores = (q.to(torch.bfloat16).float() @ kT.float()) * (dh ** -0.5)
    tp = kT.shape[-1]
    if t_real < tp:
        scores[..., t_real:] = _NEG
    probs = torch.softmax(scores, dim=-1)
    return probs.to(torch.bfloat16).float() @ v.float()
