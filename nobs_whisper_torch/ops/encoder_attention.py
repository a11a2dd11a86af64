"""Encoder self-attention kernels: K1, K3 and K9.

Ports of ``ops/encoder_attention.py``:

* K1 :func:`encoder_attention_fused_qkv` (``encoder_attention_fused_qkv``):
  LN + int8 q/k/v projections + head attention, the quantized encoder's
  default at bf16 (whisper.py:414-425);
* K3 :func:`encoder_attention_btd` (``encoder_attention_btd``): attention
  on projected q/k/v in the flat (B, T, d) layout, the float bf16
  encoder's default (whisper.py:431-447);
* K9 :func:`encoder_attention` (``encoder_attention``): the same on
  per-head (B, H, T, dh) tensors, where heads do not pair into 128 lanes
  (whisper.py:466-483).

The CUDA kernels live in ``csrc/encoder_attention.cu``; its source note
says what bounds them on an H100 and how the design answers that. Each
wrapper launches its kernel for a CUDA tensor (or raises) and runs the
``*_plain`` version beside it for a CPU tensor. ``launch_count`` (K1),
``k3_launch_count`` and ``k9_launch_count`` count kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from .quant import int8_matmul_exact, ln_f32, quantize_rows

launch_count = 0
k3_launch_count = 0
k9_launch_count = 0

# head widths the attention kernel is built for (csrc/encoder_attention.cu)
KERNEL_HEAD_DIMS = (32, 64, 128)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"nwt_encoder_attention_fused_qkv":
        [_P] * 17 + [_I] * 4 + [ctypes.c_float, _P],
        "nwt_encoder_attention_btd":
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
        "nwt_encoder_attention_bhtd":
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]}


def _attend(q, k, v, n_real: int, sm_scale: float) -> torch.Tensor:
    """The TPU kernels' attention on (B, H, T, dh) bf16 q/k/v: scores
    bf16(f32(q) * sm_scale) . k in f32, keys >= n_real at -1e30,
    p = exp(s - max), o = (bf16(p) @ v) / sum(p), in f32."""
    t = q.shape[-2]
    qs = (q.float() * sm_scale).to(torch.bfloat16).float()
    s = qs @ k.float().transpose(-1, -2)            # (B, H, T, T) f32
    if n_real < t:
        s[..., n_real:] = -1e30
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    return (p.to(torch.bfloat16).float() @ v.float()) / l


def _heads(z: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = z.shape                               # (B, T, d) -> (B, H, T, dh)
    return z.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _flat(z: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = z.shape                           # (B, H, T, dh) -> (B, T, d)
    return z.transpose(1, 2).reshape(b, t, h * dh)


def encoder_attention_fused_qkv_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv,
                                      n_real: int, sm_scale: float,
                                      n_head: int) -> torch.Tensor:
    """Plain PyTorch K1 with the Pallas kernel's numerics: LN in f32,
    row scale max(absmax, 1e-6)/127, exact int8 products, q kept f32 and
    k/v rounded to bf16, then :func:`_attend` on bf16(q * scale).
    x: (B, T, d); returns (B, T, d) in x.dtype, the pre-o attention."""
    b, t, d = x.shape
    hq, sx = quantize_rows(ln_f32(x, ln_g, ln_b))

    def proj(w, bias=None):
        y = int8_matmul_exact(hq, w["q"]) * sx * w["s"].reshape(1, d)
        return y if bias is None else y + bias.to(torch.float32)

    q = _heads((proj(wq, bq) * sm_scale).to(torch.bfloat16), n_head)
    k = _heads(proj(wk).to(torch.bfloat16), n_head)
    v = _heads(proj(wv, bv).to(torch.bfloat16), n_head)
    # q is scaled already: a scale of 1 leaves bf16 q unchanged
    return _flat(_attend(q, k, v, n_real, 1.0)).to(x.dtype)


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


def _kernel_checks(q, k, v, t: int, dh: int, n_real: int, what: str):
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(z.dtype != torch.bfloat16 or z.shape != q.shape or z.device
           != q.device for z in (q, k, v)):
        raise ValueError(f"{what} takes bf16 q, k, v of one shape on one "
                         "device")
    if t % 64 or not 0 < n_real <= t:
        raise ValueError(f"{what} takes T % 64 == 0 and 0 < n_real <= T, "
                         f"got T={t} n_real={n_real}")
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head widths "
            f"{KERNEL_HEAD_DIMS}, got {dh} (ROADMAP.md queue 2, K3/K9 head "
            "widths)")


def _launch(fn: str, q, k, v, dims, n_real: int, sm_scale: float):
    from . import _build
    lib = _build.load("encoder_attention", _SIG)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = getattr(lib, fn)(
        ptr(q), ptr(k), ptr(v), ptr(out), *dims, int(n_real),
        ctypes.c_float(sm_scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, fn)
    return out


def encoder_attention_btd_plain(q, k, v, n_real: int, sm_scale: float,
                                n_head: int) -> torch.Tensor:
    """Plain PyTorch K3: :func:`_attend` per head of the flat layout.
    The TPU kernel's head pairs with the other head's q lanes zeroed add
    exact zeros to each head's dot, so per-head attention is its function.
    Returns (B, T, d) in q.dtype."""
    return _flat(_attend(_heads(q, n_head), _heads(k, n_head),
                         _heads(v, n_head), n_real, sm_scale)).to(q.dtype)


def encoder_attention_btd(q, k, v, n_real: int, sm_scale: float,
                          n_head: int) -> torch.Tensor:
    """K3: head attention on projected q/k/v in their (B, T, d) layout
    (d = n_head * dh, head h on columns [h dh, (h + 1) dh)).

    T is padded (the caller pads to the reference's 256 quantum; the
    kernel needs T % 64 == 0); keys >= ``n_real`` are masked and padded
    query rows come out finite. Returns (B, T, d) in q.dtype."""
    global k3_launch_count
    b, t, d = q.shape
    assert n_head % 2 == 0, n_head      # head pairs, as the reference asserts
    if q.device.type == "cpu":
        return encoder_attention_btd_plain(q, k, v, n_real, sm_scale, n_head)
    dh = d // n_head
    _kernel_checks(q, k, v, t, dh, n_real, "encoder_attention_btd")
    out = _launch("nwt_encoder_attention_btd", q, k, v,
                  (b, t, n_head, dh), n_real, sm_scale)
    k3_launch_count += 1
    return out


def encoder_attention_plain(q, k, v, n_real: int,
                            sm_scale: float) -> torch.Tensor:
    """Plain PyTorch K9: :func:`_attend`, returned in q.dtype."""
    return _attend(q, k, v, n_real, sm_scale).to(q.dtype)


def encoder_attention(q, k, v, n_real: int, sm_scale: float) -> torch.Tensor:
    """K9: head attention on (B, H, T, dh) q/k/v with T padded (the caller
    pads to the reference's 256 quantum; the kernel needs T % 64 == 0);
    keys >= ``n_real`` are masked, padded query rows come out finite.
    Returns (B, H, T, dh) in q.dtype."""
    global k9_launch_count
    b, h, t, dh = q.shape
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, n_real, sm_scale)
    _kernel_checks(q, k, v, t, dh, n_real, "encoder_attention")
    out = _launch("nwt_encoder_attention_bhtd", q, k, v, (b, h, t, dh),
                  n_real, sm_scale)
    k9_launch_count += 1
    return out
