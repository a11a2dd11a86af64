"""Encoder self-attention kernels: K1, K3 and K9.

Ports of ``ops/encoder_attention.py``:

* K1 :func:`encoder_attention_fused_qkv` (``encoder_attention_fused_qkv``):
  LN + int8 q/k/v projections + head attention, the quantized encoder's
  default at bf16 (whisper.py:414-425); with ``wo``/``bo`` the o
  projection and the residual add too (``NWT_ATTN_FUSED=2``);
* K3 :func:`encoder_attention_btd` (``encoder_attention_btd``): attention
  on projected q/k/v in the flat (B, T, d) layout, the float bf16
  encoder's default (whisper.py:431-447);
* K9 :func:`encoder_attention` (``encoder_attention``): the same on
  per-head (B, H, T, dh) tensors, where heads do not pair into 128 lanes
  (whisper.py:466-483).

K1 and K3 take the reference's two opt-in int8 variants of the attention
(``_make_scores`` and ``_make_pv``, encoder_attention.py:203-367):
``int8_scores`` (``NWT_ATTN_I8``) and ``int8_pv`` (``NWT_ATTN_I8PV``).

The CUDA kernels live in ``csrc/encoder_attention.cu``; its source note
says what bounds them on an H100 and how the design answers that. K1's
q/k/v and o projections run on the int8 ``wgmma`` GEMMs of
``csrc/proj_wgmma.cuh`` (K10's and K2's), which read each weight as its
K-major copy (``ops/quant.py::k_major``, made once per QTensor). Each
wrapper launches its kernel for a CUDA tensor (or raises) and runs the
``*_plain`` version beside it for a CPU tensor. ``launch_count`` (K1),
``k3_launch_count`` and ``k9_launch_count`` count launches of the default
variants only; ``variant_launch_count`` counts the others by
:func:`variant` name ("K1-o", "K1-i8s", "K3-i8s-i8pv", ...).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import _build
from .quant import int8_matmul_exact, k_major, ln_f32, quantize_rows

launch_count = 0
k3_launch_count = 0
k9_launch_count = 0
variant_launch_count: collections.Counter = collections.Counter()

# head widths the attention kernel is built for (csrc/encoder_attention.cu)
KERNEL_HEAD_DIMS = (32, 64, 128)
PAIR = 128          # the TPU kernels' head-pair lane block (2 heads of 64)
# int8_prep's partial absmax per (batch row, head), csrc/encoder_attention.cu
AMAX_PARTS = 8

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"nwt_encoder_attention_fused_qkv":
        [_P] * 28 + [_I] * 4 + [ctypes.c_float, _I, _P],
        "nwt_encoder_attention_btd":
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P],
        "nwt_encoder_attention_btd_int8":
        [_P] * 9 + [_I] * 4 + [ctypes.c_float, _I, _P],
        "nwt_encoder_attention_bhtd":
        [_P] * 4 + [_I] * 5 + [ctypes.c_float, _P]}


def variant(key: str, fuse_o: bool = False, int8_scores: bool = False,
            int8_pv: bool = False) -> str:
    """The name a launch of kernel ``key`` counts under: "K1", "K1-o",
    "K1-i8s", "K1-o-i8s-i8pv", ..."""
    return "-".join([key] + ["o"] * fuse_o + ["i8s"] * int8_scores
                    + ["i8pv"] * int8_pv)


def _head_scale(z: torch.Tensor, n_real: int) -> torch.Tensor:
    """One scale per (batch row, head) of (B, H, T, dh) f32: max(absmax
    over rows < n_real, 1e-6) / 127. Padded rows stay out of the
    statistic (encoder_attention.py:227-238, :308-319)."""
    a = torch.amax(torch.abs(z[..., :n_real, :]), dim=(-2, -1), keepdim=True)
    return torch.clamp(a, min=1e-6) / 127.0


def _quant_by(z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """clip(round(z * (1 / s))): k and v multiply by the reciprocal."""
    return torch.clamp(torch.round(z * (1.0 / s)), -127, 127)


def _attend(q, k, v, n_real: int, sm_scale: float,
            int8_scores: bool = False, int8_pv: bool = False
            ) -> torch.Tensor:
    """The TPU kernels' attention on (B, H, T, dh) q/k/v (k, v bf16; q bf16
    or, in K1, the f32 projection), in f32:

    * scores: bf16(f32(q) * sm_scale) . k in f32; with ``int8_scores``
      q quantized per row and head (divided by its scale), k per head
      (times the reciprocal of its scale), s = f32(int dot) * (sq * (sk *
      sm_scale)). Keys >= n_real at -1e30.
    * p = exp(s - max); o = (bf16(p) @ v) / sum(p); with ``int8_pv``
      pq = round(p * 127), v per head, o = (f32(int pq . vq) /
      max(sum pq, 1)) * sv.

    Integer dots run in float64, exact, then round to f32 once as the
    int32 accumulators do."""
    t = q.shape[-2]
    if int8_scores:
        qf, kf = q.float(), k.float()
        sq = torch.clamp(torch.amax(torch.abs(qf), dim=-1, keepdim=True),
                         min=1e-6) / 127.0
        qq = torch.clamp(torch.round(qf / sq), -127, 127)
        sk = _head_scale(kf, n_real)
        kq = _quant_by(kf, sk)
        s = (qq.double() @ kq.double().transpose(-1, -2)).float()
        s = s * (sq * (sk * sm_scale))
    else:
        qs = (q.float() * sm_scale).to(torch.bfloat16).float()
        s = qs @ k.float().transpose(-1, -2)        # (B, H, T, T) f32
    if n_real < t:
        s[..., n_real:] = -1e30
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    del s
    if int8_pv:
        vf = v.float()
        sv = _head_scale(vf, n_real)
        vq = _quant_by(vf, sv)
        pq = torch.round(p * 127.0)
        del p
        lq = torch.clamp(torch.sum(pq, dim=-1, keepdim=True), min=1.0)
        return ((pq.double() @ vq.double()).float() / lq) * sv
    l = torch.sum(p, dim=-1, keepdim=True)
    return (p.to(torch.bfloat16).float() @ v.float()) / l


def _heads(z: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = z.shape                               # (B, T, d) -> (B, H, T, dh)
    return z.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _flat(z: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = z.shape                           # (B, H, T, dh) -> (B, T, d)
    return z.transpose(1, 2).reshape(b, t, h * dh)


def _fused_o_plain(x, a, wo, bo) -> torch.Tensor:
    """K1's fused o projection (encoder_attention.py:461-476, :490-493):
    acc = f32(x) + bo, then per head pair j in order, the pair's f32
    attention output (128 columns) quantized per row and
    acc += (f32(aq @ wo[128 j : 128 (j + 1)]) * sa) * so. Returns x.dtype."""
    d = x.shape[-1]
    so = wo["s"].reshape(1, d).to(torch.float32)
    acc = x.to(torch.float32) + bo.to(torch.float32)
    for j in range(d // PAIR):
        cols = slice(j * PAIR, (j + 1) * PAIR)
        aq, sa = quantize_rows(a[..., cols])
        acc = acc + int8_matmul_exact(aq, wo["q"][cols, :]) * sa * so
    return acc.to(x.dtype)


def encoder_attention_fused_qkv_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv,
                                      n_real: int, sm_scale: float,
                                      n_head: int, int8_scores: bool = False,
                                      int8_pv: bool = False, wo=None,
                                      bo=None) -> torch.Tensor:
    """Plain PyTorch K1: :func:`fused_qkv_plain`."""
    return fused_qkv_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real,
                           sm_scale, n_head, int8_scores, int8_pv, wo, bo)


def fused_qkv_plain(x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real: int,
                    sm_scale: float, n_head: int, int8_scores: bool = False,
                    int8_pv: bool = False, wo=None, bo=None) -> torch.Tensor:
    """K1's function, shared with K12's plain version (which counts as
    K12 alone), with the Pallas kernel's numerics: LN in f32,
    row scale max(absmax, 1e-6)/127, exact int8 products, q kept f32 (the
    int8 scores quantize it unscaled) and k/v rounded to bf16, then
    :func:`_attend`; with ``wo``, :func:`_fused_o_plain` on the f32
    attention output. x: (B, T, d); returns (B, T, d) in x.dtype: the
    pre-o attention, or x + attention @ wo + bo."""
    b, t, d = x.shape
    hq, sx = quantize_rows(ln_f32(x, ln_g, ln_b))

    def proj(w, bias=None):
        y = int8_matmul_exact(hq, w["q"]) * sx * w["s"].reshape(1, d)
        return y if bias is None else y + bias.to(torch.float32)

    q = _heads(proj(wq, bq), n_head)
    k = _heads(proj(wk).to(torch.bfloat16), n_head)
    v = _heads(proj(wv, bv).to(torch.bfloat16), n_head)
    a = _flat(_attend(q, k, v, n_real, sm_scale, int8_scores, int8_pv))
    if wo is None:
        return a.to(x.dtype)
    return _fused_o_plain(x, a, wo, bo)


def encoder_attention_fused_qkv(x, ln_g, ln_b, wq, bq, wk, wv, bv,
                                n_real: int, sm_scale: float, n_head: int,
                                int8_scores: bool = False,
                                int8_pv: bool = False, wo=None, bo=None
                                ) -> torch.Tensor:
    """LN + q/k/v projections + head attention in one kernel call; pass
    ``wo``/``bo`` to fuse the o projection and the residual add too.

    ``x``: (B, T, d) residual stream, T padded to a multiple of 64 on the
    card (keys >= ``n_real`` are masked);
    ``wq``/``wk``/``wv``/``wo``: int8 QTensors ({"q": (d, d) int8, "s":
    (1, d) f32}, (d_in, d_out) layout; the kernel reads their K-major
    copies, made at the first launch); ``bq``/``bv``/``bo``: (d,) biases
    (Whisper's k projection has none); ``ln_g``/``ln_b``: (d,) LayerNorm
    params; ``int8_scores``/``int8_pv``: the int8 QK^T and PV variants.
    Returns (B, T, d) in x.dtype: the pre-o-projection attention, or with
    ``wo`` the finished ``x + attn @ wo + bo``, whose per-pair o-input
    quantization is finer than the unfused full-row one."""
    global launch_count
    _build.no_autograd("K1", x, ln_g, ln_b, wq, bq, wk, wv, bv, wo, bo)
    b, t, d = x.shape
    assert n_head % 2 == 0 and d % 128 == 0 and 2 * (d // n_head) == 128, \
        (d, n_head)
    fuse_o = wo is not None
    if x.device.type == "cpu":
        return encoder_attention_fused_qkv_plain(
            x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real, sm_scale, n_head,
            int8_scores, int8_pv, wo, bo)
    ops = fused_qkv_operands(x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real,
                             n_head, int8_scores, int8_pv, wo, bo)
    lib = _build.load("encoder_attention", _SIG)
    err = lib.nwt_encoder_attention_fused_qkv(
        *(ctypes.c_void_p(z.data_ptr()) for z in ops),
        b, t, d, int(n_real), ctypes.c_float(sm_scale),
        variant_flags(int8_scores, int8_pv, fuse_o),
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(err, "encoder_attention_fused_qkv")
    name = variant("K1", fuse_o, int8_scores, int8_pv)
    if name == "K1":
        with _build.COUNT_LOCK:
            launch_count += 1
    else:
        with _build.COUNT_LOCK:
            variant_launch_count[name] += 1
    return ops[14]


def variant_flags(int8_scores: bool, int8_pv: bool,
                  fuse_o: bool = False) -> int:
    """The C entry points' variant bits (csrc/encoder_attention.cu)."""
    return int(bool(int8_scores)) | int(bool(int8_pv)) << 1 | \
        int(bool(fuse_o)) << 2


def _i8_workspace(b, t, d, n_head, int8_scores, int8_pv, dev):
    """Scratch of the int8 variants (csrc/encoder_attention.cu): qq and kq
    (B, T, d) int8, qq's (B T, H) row-head scales, vq (B, H, 64, T) int8
    (v transposed per head, each 32-key step's keys in the order the
    kernel's score accumulator leaves them), and the per-head absmax of k
    and v as float bits, (2, B, H, AMAX_PARTS): maxima over AMAX_PARTS
    ranges of rows."""
    i8 = lambda *s: torch.empty(s, dtype=torch.int8, device=dev)
    none = torch.empty(0, device=dev)
    return (i8(b, t, d) if int8_scores else none,
            torch.empty((b * t, n_head), dtype=torch.float32, device=dev)
            if int8_scores else none,
            i8(b, t, d) if int8_scores else none,
            i8(b, n_head, d // n_head, t) if int8_pv else none,
            torch.empty((2, b, n_head, AMAX_PARTS), dtype=torch.int32,
                        device=dev))


def fused_o_workspace(m: int, d: int, dev) -> list:
    """K1's scratch for the fused o projection: the f32 attention output
    (m, d), its int8 copy quantized per (row, head pair) and the pairs'
    scales (m, d / PAIR); csrc/encoder_attention.cu's requant chunk
    ``O_CHUNK`` is the pair."""
    return [torch.empty((m, d), dtype=torch.float32, device=dev),
            torch.empty((m, d), dtype=torch.int8, device=dev),
            torch.empty((m, d // PAIR), dtype=torch.float32, device=dev)]


def fused_qkv_operands(x, ln_g, ln_b, wq, bq, wk, wv, bv, n_real: int,
                       n_head: int, int8_scores: bool, int8_pv: bool,
                       wo=None, bo=None) -> list:
    """Check K1's inputs for the card and return the 28 tensors of
    ``nwt_encoder_attention_fused_qkv`` in its argument order (inputs,
    output at index 14, workspace); the caller holds them until the
    launch (ctypes gets raw pointers). The weights go as their K-major
    copies, made once per QTensor and kept in it."""
    b, t, d = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or t % 64 or not 0 < n_real <= t:
        raise ValueError(f"kernel takes bf16 x with T % 64 == 0 and "
                         f"0 < n_real <= T, got {x.dtype} T={t} "
                         f"n_real={n_real}")
    fuse_o = wo is not None
    for w in (wq, wk, wv) + ((wo,) if fuse_o else ()):
        if w["q"].dtype != torch.int8 or tuple(w["q"].shape) != (d, d):
            raise ValueError("weights must be (d, d) int8 QTensors")
    dev = x.device
    f32 = lambda z: z.to(device=dev, dtype=torch.float32).contiguous()
    ws = (wq, wk, wv) + ((wo,) if fuse_o else ())
    w = [k_major(z) for z in ws]
    s = [f32(z["s"]).reshape(d) for z in ws]
    none = torch.empty(0, device=dev)
    m = b * t
    if fuse_o:
        fused = [w[3], s[3], f32(bo)]
        work_o = fused_o_workspace(m, d, dev)
    else:
        fused, work_o = [none] * 3, [none] * 3
    # q in f32, unscaled, where the int8 scores quantize it
    q = torch.empty((b, t, d), device=dev,
                    dtype=torch.float32 if int8_scores else torch.bfloat16)
    x = x.contiguous()
    return [x, f32(ln_g), f32(ln_b), w[0], s[0], f32(bq), w[1], s[1],
            w[2], s[2], f32(bv), *fused,
            torch.empty_like(x),                                  # out
            torch.empty((m, d), dtype=torch.int8, device=dev),    # xq
            torch.empty((m,), dtype=torch.float32, device=dev),   # sx
            q, torch.empty_like(x), torch.empty_like(x),          # q, k, v
            *work_o,                                              # a32 aq sa
            *_i8_workspace(b, t, d, n_head, int8_scores, int8_pv, dev)]


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


def _launch_btd_int8(q, k, v, b, t, n_head, n_real, sm_scale, int8_scores,
                     int8_pv):
    lib = _build.load("encoder_attention", _SIG)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    qq, qs, kq, vq, amax = _i8_workspace(b, t, q.shape[-1], n_head,
                                         int8_scores, int8_pv, q.device)
    ptr = lambda z: ctypes.c_void_p(z.data_ptr())
    err = lib.nwt_encoder_attention_btd_int8(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(qq), ptr(qs), ptr(kq),
        ptr(vq), ptr(amax), b, t, n_head, int(n_real),
        ctypes.c_float(sm_scale), variant_flags(int8_scores, int8_pv),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(err, "nwt_encoder_attention_btd_int8")
    return out


def encoder_attention_btd_plain(q, k, v, n_real: int, sm_scale: float,
                                n_head: int, int8_scores: bool = False,
                                int8_pv: bool = False) -> torch.Tensor:
    """Plain PyTorch K3: :func:`_attend` per head of the flat layout.
    The TPU kernel's head pairs with the other head's q lanes zeroed add
    exact zeros to each head's dot (and leave each head's absmax its own),
    so per-head attention is its function. Returns (B, T, d) in q.dtype."""
    return _flat(_attend(_heads(q, n_head), _heads(k, n_head),
                         _heads(v, n_head), n_real, sm_scale, int8_scores,
                         int8_pv)).to(q.dtype)


def encoder_attention_btd(q, k, v, n_real: int, sm_scale: float,
                          n_head: int, int8_scores: bool = False,
                          int8_pv: bool = False) -> torch.Tensor:
    """K3: head attention on projected q/k/v in their (B, T, d) layout
    (d = n_head * dh, head h on columns [h dh, (h + 1) dh)), with the
    optional int8 scores and PV (heads of 64 on the card).

    T is padded (the caller pads to the reference's 256 quantum; the
    kernel needs T % 64 == 0); keys >= ``n_real`` are masked and padded
    query rows come out finite. Returns (B, T, d) in q.dtype."""
    global k3_launch_count
    _build.no_autograd("K3", q, k, v)
    b, t, d = q.shape
    assert n_head % 2 == 0, n_head      # head pairs, as the reference asserts
    if q.device.type == "cpu":
        return encoder_attention_btd_plain(q, k, v, n_real, sm_scale, n_head,
                                           int8_scores, int8_pv)
    dh = d // n_head
    _kernel_checks(q, k, v, t, dh, n_real, "encoder_attention_btd")
    if not (int8_scores or int8_pv):
        out = _launch("nwt_encoder_attention_btd", q, k, v,
                      (b, t, n_head, dh), n_real, sm_scale)
        with _build.COUNT_LOCK:
            k3_launch_count += 1
        return out
    if dh != 64:
        raise NotImplementedError(
            "encoder_attention_btd: the int8 variants are built for heads "
            f"of 64 (the reference's head pairs), got {dh}")
    out = _launch_btd_int8(q, k, v, b, t, n_head, n_real, sm_scale,
                           int8_scores, int8_pv)
    with _build.COUNT_LOCK:
        variant_launch_count[variant("K3", False, int8_scores, int8_pv)] += 1
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
    _build.no_autograd("K9", q, k, v)
    b, h, t, dh = q.shape
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, n_real, sm_scale)
    _kernel_checks(q, k, v, t, dh, n_real, "encoder_attention")
    out = _launch("nwt_encoder_attention_bhtd", q, k, v, (b, h, t, dh),
                  n_real, sm_scale)
    with _build.COUNT_LOCK:
        k9_launch_count += 1
    return out
