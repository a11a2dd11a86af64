"""K1: fused LN + int8 q/k/v projections + head attention for the encoder.

Port of ``ops/encoder_attention.py::encoder_attention_fused_qkv`` (the
default attention of the quantized encoder, whisper.py:414-425). The CUDA
kernel lives in ``csrc/encoder_attention.cu``; its source note says what
bounds it on an H100 and how the design answers that.

:func:`encoder_attention_fused_qkv` launches the kernel for a CUDA tensor
(or raises) and runs :func:`encoder_attention_fused_qkv_plain` for a CPU
tensor. ``launch_count`` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from .quant import int8_matmul_exact, ln_f32, quantize_rows

launch_count = 0

_SIG = {"nwt_encoder_attention_fused_qkv":
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p]}


def encoder_attention_fused_qkv_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv,
                                      n_real: int, sm_scale: float,
                                      n_head: int) -> torch.Tensor:
    """Plain PyTorch K1 with the Pallas kernel's numerics: LN in f32,
    row scale max(absmax, 1e-6)/127, exact int8 products, q kept f32 and
    k/v rounded to bf16, scores bf16(q * scale) . bf16(k) in f32 with keys
    >= n_real at -1e30, p = exp(s - max), o = (bf16(p) @ v) / sum(p).
    x: (B, T, d); returns (B, T, d) in x.dtype, the pre-o attention."""
    b, t, d = x.shape
    dh = d // n_head
    hq, sx = quantize_rows(ln_f32(x, ln_g, ln_b))

    def proj(w, bias=None):
        y = int8_matmul_exact(hq, w["q"]) * sx * w["s"].reshape(1, d)
        return y if bias is None else y + bias.to(torch.float32)

    def heads(z):                                   # (B, T, d) -> (B, H, T, dh)
        return z.reshape(b, t, n_head, dh).transpose(1, 2)

    q = heads((proj(wq, bq) * sm_scale).to(torch.bfloat16)).float()
    k = heads(proj(wk).to(torch.bfloat16)).float()
    v = heads(proj(wv, bv).to(torch.bfloat16)).float()
    s = q @ k.transpose(-1, -2)                     # (B, H, T, T) f32
    if n_real < t:
        s[..., n_real:] = -1e30
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ v) / l
    return o.transpose(1, 2).reshape(b, t, d).to(x.dtype)


def encoder_attention_fused_qkv(x, ln_g, ln_b, wq, bq, wk, wv, bv,
                                n_real: int, sm_scale: float, n_head: int
                                ) -> torch.Tensor:
    """LN + q/k/v projections + head attention in one kernel call.

    ``x``: (B, T, d) residual stream, T padded to a multiple of 64 on the
    card (keys >= ``n_real`` are masked);
    ``wq``/``wk``/``wv``: int8 QTensors ({"q": (d, d) int8, "s": (1, d)
    f32}, (d_in, d_out) layout); ``bq``/``bv``: (d,) biases (Whisper's k
    projection has none); ``ln_g``/``ln_b``: (d,) LayerNorm params.
    Returns the pre-o-projection attention (B, T, d) in x.dtype."""
    global launch_count
    b, t, d = x.shape
    assert n_head % 2 == 0 and d % 128 == 0 and 2 * (d // n_head) == 128, \
        (d, n_head)
    if x.device.type == "cpu":
        return encoder_attention_fused_qkv_plain(
            x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real, sm_scale, n_head)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or t % 64 or not 0 < n_real <= t:
        raise ValueError(f"kernel takes bf16 x with T % 64 == 0 and "
                         f"0 < n_real <= T, got {x.dtype} T={t} "
                         f"n_real={n_real}")
    for w in (wq, wk, wv):
        if w["q"].dtype != torch.int8 or tuple(w["q"].shape) != (d, d):
            raise ValueError("weights must be (d, d) int8 QTensors")
    from . import _build
    lib = _build.load("encoder_attention", _SIG)
    dev = x.device
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    x = x.contiguous()
    w = [z["q"].contiguous() for z in (wq, wk, wv)]
    s = [f32(z["s"]).reshape(d) for z in (wq, wk, wv)]
    g, be, bq32, bv32 = f32(ln_g), f32(ln_b), f32(bq), f32(bv)
    out = torch.empty_like(x)
    xq = torch.empty((b * t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((b * t,), dtype=torch.float32, device=dev)
    q, k, v = (torch.empty_like(x) for _ in range(3))
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = lib.nwt_encoder_attention_fused_qkv(
        ptr(x), ptr(g), ptr(be), ptr(w[0]), ptr(s[0]), ptr(bq32),
        ptr(w[1]), ptr(s[1]), ptr(w[2]), ptr(s[2]), ptr(bv32),
        ptr(out), ptr(xq), ptr(sx), ptr(q), ptr(k), ptr(v),
        b, t, d, int(n_real), ctypes.c_float(sm_scale),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "encoder_attention_fused_qkv")
    launch_count += 1
    return out
