"""Decoder cross-attention: the packed bf16 and the int8 cross-KV layouts,
and the single-query decode kernels K4 and K5.

Port of ``ops/attention_pallas.py``:

* the layouts: :func:`pack_cross_kv_bf16` (:138), K as (…, Dh, Tp) bf16;
  :func:`quant_kv_padded` (:38) and :func:`quantize_cross_kv` (:57), int8
  with per-position scales, K as (…, Dh, Tp); Tp is T padded to a multiple
  of 128, the padded positions masked by index (bf16) or by a zero scale
  (int8);
* the XLA functions of the reference, plain torch here:
  :func:`cross_attention_kt_xla` (:210), the packed layout's default;
  :func:`cross_attention_dequant_reference` (:257), the int8 layout's
  default and its path for S > 1; :func:`cross_attention_bf16_reference`
  (:246);
* K4 :func:`cross_attention_decode_bf16` (:174) and K5
  :func:`cross_attention_decode_q8` (:95), opt-in in the reference
  (``NWT_XATTN_KERNEL``, ``NWT_Q8_KV_PALLAS``; gates in
  ``models/whisper.py``). Their CUDA kernels live in
  ``csrc/cross_attention_decode.cu``, whose source note says what bounds
  them on an H100. Both split the positions over a thread-block cluster:
  :func:`k4_plan` and :func:`k5_plan` are their choices of cluster size
  and slice (K4 streams its slice through a ring of shared memory, K5
  stages its K whole). Each wrapper
  launches its kernel for a CUDA tensor (or raises) and runs the
  ``*_plain`` version beside it for a CPU tensor; ``k4_launch_count`` and
  ``k5_launch_count`` count kernel launches only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..core.device import scalar
from . import _build

_NEG = -1e30

QKV = Dict[str, torch.Tensor]

# head widths the decode kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128)

k4_launch_count = 0
k5_launch_count = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = {"nwt_xattn_decode_bf16": [_P] * 4 + [_I] * 4 + [_F, _P],
        "nwt_xattn_decode_q8": [_P] * 6 + [_I] * 3 + [_F, _P]}

# csrc/cross_attention_decode.cu's K5 constants: threads a block, the
# largest cluster, the slice step in positions, blocks an SM the split aims
# at, blocks an SM a slice leaves room for, a block's shared memory
K5_THREADS, K5_MAX_C, K5_STEP = 256, 16, 16
K5_TARGET, K5_RESIDENT, K5_SMEM_MAX = 1, 2, 232448
K5_PK = 4 * K5_THREADS   # floats of the score groups' partial sums
K5_BOX, K5_MAX_BOX = 256, 16   # positions a TMA box of K; boxes a slice


# csrc/cross_attention_decode.cu's K4 constants: compute threads a block,
# the largest cluster, the slice step, the longest slice and the shortest a
# split leaves, in positions; bytes a ring stage and the stages, blocks an
# SM the split aims at, a block's shared memory
K4_THREADS, K4_MAX_C, K4_STEP, K4_SPAN = 128, 16, 8, 1024
K4_MIN_SLICE, K4_STAGE, K4_STAGES = 192, 8192, 3
K4_TARGET, K4_SMEM_MAX = 2, 232448
K4_PK = 4 * K4_THREADS   # floats of the score groups' partial sums


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k5_boxes(s: int) -> Tuple[int, int]:
    """(boxes, positions a box) of K5's TMA copies of a slice of ``s``
    positions: as few boxes of at most ``K5_BOX`` positions as cover it,
    all of one width, a multiple of 16."""
    m = s // K5_STEP
    nb = -(-m // (K5_BOX // K5_STEP))
    return nb, -(-m // nb) * K5_STEP


def k5_smem(dh: int, s: int) -> int:
    """Shared-memory bytes of a K5 block with slices of ``s`` positions:
    the mbarriers, partial sums and exchange slots (``k5_head``), then the
    K boxes and the two scale rows (V is read from L2)."""
    warps = K5_THREADS // 32
    head = (8 * (K5_MAX_BOX + 4) + 4 * warps * dh + 4 * K5_PK + 4 * dh
            + 8 * K5_MAX_C + 4 * dh + 4 * warps)
    nb, bw = k5_boxes(s)
    return _round_up(head, 128) + dh * nb * bw + 8 * s


@functools.lru_cache(maxsize=256)
def k5_plan(bh: int, tp: int, sms: int, dh: int = 64) -> Tuple[int, int]:
    """K5's (cluster size C, slice S) for ``bh`` (batch row, head) pairs
    over ``tp`` positions on a card of ``sms`` multiprocessors, as
    ``csrc/cross_attention_decode.cu::k5_plan`` chooses them: C doubles
    while the grid has fewer than ``K5_TARGET`` blocks an SM, or a slice
    leaves no room for ``K5_RESIDENT`` blocks an SM, up to ``K5_MAX_C``
    and half the 16-position chunks; S is the chunks over C, rounded up,
    in positions. C = 0 where no slice fits a block (Tp too long)."""
    chunks = tp // K5_STEP
    slice_ = lambda c: -(-chunks // c) * K5_STEP
    c = 1
    while (c < K5_MAX_C and 2 * c <= chunks
           and (c * bh < K5_TARGET * sms
                or k5_smem(dh, slice_(c)) > K5_SMEM_MAX // K5_RESIDENT)):
        c *= 2
    s = slice_(c)
    fits = k5_smem(dh, s) <= K5_SMEM_MAX and k5_boxes(s)[0] <= K5_MAX_BOX
    return (c if fits else 0), s


def k4_rows(s: int, dh: int) -> int:
    """Rows of K one stage of K4's ring holds for slices of ``s`` <=
    ``K4_SPAN`` positions: the largest power of two of rows of ``s`` bf16
    in ``K4_STAGE`` bytes, at most ``dh`` (4 for turbo's slices of 768)."""
    r = 1
    while 2 * r <= dh and 2 * r * 2 * s <= K4_STAGE:
        r *= 2
    return r


def k4_vbox(dh: int) -> int:
    """Positions of V one stage holds: as many rows of ``dh`` bf16."""
    return K4_STAGE // (2 * dh)


def k4_smem(dh: int, s: int) -> int:
    """Shared-memory bytes of a K4 block with slices of ``s`` positions:
    the mbarriers (a full and an empty one a stage), partial sums and
    exchange slots (``k4_head``), the ring and the scores row. The slice
    itself is not held: it streams."""
    warps = K4_THREADS // 32
    head = (8 * (2 * K4_STAGES + 4) + 4 * K4_PK + 4 * dh + 8 * K4_MAX_C
            + 4 * dh + 4 * warps)
    return _round_up(head, 128) + K4_STAGES * K4_STAGE + 4 * s


@functools.lru_cache(maxsize=256)
def k4_plan(bh: int, tp: int, sms: int) -> Tuple[int, int]:
    """K4's (cluster size C, slice S) for ``bh`` (batch row, head) pairs
    over ``tp`` positions on a card of ``sms`` multiprocessors, as
    ``csrc/cross_attention_decode.cu::k4_plan`` chooses them: C doubles
    while the slice is longer than ``K4_SPAN``, or while the grid has
    fewer than ``K4_TARGET`` blocks an SM and halving the slice leaves at
    least ``K4_MIN_SLICE`` positions, up to ``K4_MAX_C`` and half the
    8-position chunks; S is the chunks over C, rounded up, in positions.
    C = 0 where the slice is still longer than ``K4_SPAN`` (Tp too long).
    A block's shared memory (:func:`k4_smem`, the ring and the scores
    row) does not limit C."""
    chunks = tp // K4_STEP
    slice_ = lambda c: -(-chunks // c) * K4_STEP
    c = 1
    while (c < K4_MAX_C and 2 * c <= chunks
           and (slice_(c) > K4_SPAN
                or (c * bh < K4_TARGET * sms
                    and slice_(2 * c) >= K4_MIN_SLICE))):
        c *= 2
    s = slice_(c)
    return (c if s <= K4_SPAN else 0), s


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

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


def quant_kv_padded(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp (..., T, Dh) -> (int8 (..., Tp, Dh), f32 scales (..., Tp)).

    Per-position absmax quantization with this function's own floor,
    s = max(absmax / 127, 1e-12), q = clip(round_half_even(x / s)); T is
    padded to a multiple of 128 with zero-scale (masked) positions. Any
    leading dims: a whole (L, B, H, ...) stack or one layer."""
    t = x.shape[-2]
    t_pad = _round_up(t, 128)
    x32 = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    s = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    q = torch.nn.functional.pad(q, (0, 0, 0, t_pad - t))
    s = torch.nn.functional.pad(s[..., 0], (0, t_pad - t))   # 0 = masked
    return q, s


def quantize_cross_kv(
    cross_kv: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[QKV, QKV]:
    """(xk, xv) fp (L, B, H, T, Dh) -> int8 with per-position scales: K
    stored transposed (L, B, H, Dh, Tp) for the scores product, V
    (L, B, H, Tp, Dh), scales (L, B, H, Tp)."""
    xk, xv = cross_kv
    kq, ks = quant_kv_padded(xk)
    vq, vs = quant_kv_padded(xv)
    return ({"q": kq.transpose(-1, -2).contiguous(), "s": ks},
            {"q": vq, "s": vs})


# ---------------------------------------------------------------------------
# the reference's XLA functions (plain torch)
# ---------------------------------------------------------------------------

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


def cross_attention_kt_xla_grouped(q: torch.Tensor, packed, t_real: int
                                   ) -> torch.Tensor:
    """Beam search's cross-attention: q (B, G, H, S, Dh), G beams of an
    element sharing its one packed K/V (B, H, Dh, Tp), so the cross-KV is
    read once an element, not once a beam. G is folded into the query
    axis of :func:`cross_attention_kt_xla`, which is exact: the masking
    and the softmax act per query row. Returns (B, G, H, S, Dh) f32."""
    b, g, h, s, dh = q.shape
    q4 = q.transpose(1, 2).reshape(b, h, g * s, dh)
    out = cross_attention_kt_xla(q4, packed, t_real)
    return out.reshape(b, h, g, s, dh).transpose(1, 2)


def cross_attention_bf16_reference(q: torch.Tensor, packed, t_real: int
                                   ) -> torch.Tensor:
    """The packed layout's f32 reference: K/V sliced to the real positions,
    f32 scores and softmax, f32 probabilities @ V. Returns f32."""
    kT = packed["kT"][..., :t_real].float()
    v = packed["v"][..., :t_real, :].float()
    dh = q.shape[-1]
    scores = (q.float() @ kT) * (dh ** -0.5)
    return torch.softmax(scores, dim=-1) @ v


def cross_attention_dequant_reference(q: torch.Tensor, kq: QKV, vq: QKV
                                      ) -> torch.Tensor:
    """Int8 cross-KV in f32: K and V dequantized per position, scores
    scaled by dh^-0.5, zero-scale positions at -1e30, f32 softmax and
    probabilities @ V. q (B, H, S, Dh) -> (B, H, S, Dh) f32."""
    k = kq["q"].float() * kq["s"][..., None, :]          # (B, H, Dh, Tp)
    v = vq["q"].float() * vq["s"][..., None]             # (B, H, Tp, Dh)
    dh = q.shape[-1]
    scores = (q.float() @ k) * (dh ** -0.5)
    scores = torch.where((kq["s"] > 0)[:, :, None, :], scores,
                         scalar(_NEG, scores.dtype, scores.device))
    return torch.softmax(scores, dim=-1) @ v


# ---------------------------------------------------------------------------
# K4 and K5: single-query decode kernels
# ---------------------------------------------------------------------------

def _softmax_normalised(scores: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` as the TPU kernels compute it in f32:
    exp(s - max) / sum, the row normalised before any bf16 cast."""
    p = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return p / torch.sum(p, dim=-1, keepdim=True)


def cross_attention_decode_bf16_plain(q: torch.Tensor, packed,
                                      t_real: int) -> torch.Tensor:
    """Plain PyTorch K4 with the Pallas kernel's numerics: raw =
    bf16(q) . kT in f32, scores = raw * dh^-0.5 with positions >= t_real
    at -1e30, f32 softmax, out = bf16(probs) @ v in f32. (B, H, 1, Dh)
    f32."""
    kT, v = packed["kT"], packed["v"]
    dh = q.shape[-1]
    raw = q.to(torch.bfloat16).float() @ kT.float()     # (B, H, 1, Tp)
    scores = raw * float(dh) ** -0.5
    if t_real < kT.shape[-1]:
        scores[..., t_real:] = _NEG
    probs = _softmax_normalised(scores)
    return probs.to(torch.bfloat16).float() @ v.float()


def cross_attention_decode_q8_plain(q: torch.Tensor, kq: QKV, vq: QKV
                                    ) -> torch.Tensor:
    """Plain PyTorch K5 with the Pallas kernel's numerics
    (``_xattn_kernel``): bf16(q) . kq in f32 (int8 is exact in bf16),
    scores = (raw * ks) * dh^-0.5 where ks > 0 else -1e30, f32 softmax,
    pv = bf16(probs * vs), out = pv @ vq in f32. (B, H, 1, Dh) f32."""
    dh = q.shape[-1]
    raw = q.to(torch.bfloat16).float() @ kq["q"].float()   # (B, H, 1, Tp)
    ks = kq["s"][:, :, None, :]
    scores = torch.where(ks > 0, raw * ks * float(dh) ** -0.5,
                         torch.tensor(_NEG, device=raw.device))
    probs = _softmax_normalised(scores)
    pv = (probs * vq["s"][:, :, None, :]).to(torch.bfloat16).float()
    return pv @ vq["q"].float()


def _check_decode(q: torch.Tensor, what: str) -> Tuple[int, int, int]:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, s, dh = q.shape
    if s != 1:
        raise ValueError(f"{what} is single-query, got S={s}")
    if dh not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: the CUDA kernel is built for head widths "
            f"{KERNEL_HEAD_DIMS}, got {dh} (ROADMAP.md queue 2, K4/K5 head "
            "widths)")
    return b, h, dh


def cross_attention_decode_bf16(q: torch.Tensor, packed,
                                t_real: int) -> torch.Tensor:
    """K4: single-query cross-attention over the packed bf16 layout.

    ``q``: (B, H, 1, Dh), rounded to bf16 as the reference's wrapper does;
    ``packed``: {"kT": (B, H, Dh, Tp) bf16, "v": (B, H, Tp, Dh) bf16}; keys
    at positions >= ``t_real`` are masked. Tp % 8 == 0 and 16-byte aligned
    kT and v (the kernel's bulk copies), as
    ``pack_cross_kv_bf16`` lays them out. Returns (B, H, 1, Dh) f32."""
    _build.no_autograd("K4", q, packed)
    if q.device.type == "cpu":
        return cross_attention_decode_bf16_plain(q, packed, t_real)
    b, h, dh = _check_decode(q, "cross_attention_decode_bf16")
    kT, v = packed["kT"], packed["v"]
    tp = kT.shape[-1]
    if (kT.dtype != torch.bfloat16 or v.dtype != torch.bfloat16
            or tuple(kT.shape) != (b, h, dh, tp)
            or tuple(v.shape) != (b, h, tp, dh)
            or tp % K4_STEP or not 0 < t_real <= tp):
        raise ValueError(
            f"K4 takes bf16 kT (B, H, Dh, Tp) and v (B, H, Tp, Dh) with "
            f"Tp % {K4_STEP} == 0 and 0 < t_real <= Tp; got kT "
            f"{tuple(kT.shape)} {kT.dtype}, v {tuple(v.shape)} {v.dtype}, "
            f"t_real {t_real}")
    lib = _build.load("cross_attention_decode", _SIG)
    # every converted tensor stays in a name until the launch has returned
    qb = q.to(torch.bfloat16).contiguous()
    kT, v = kT.contiguous(), v.contiguous()
    if kT.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("K4 takes kT and v on 16-byte boundaries (its bulk "
                         "copies)")
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    err = lib.nwt_xattn_decode_bf16(
        qb.data_ptr(), kT.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
        dh, tp, int(t_real), ctypes.c_float(float(dh) ** -0.5),
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err == 1:   # cudaErrorInvalidValue: what the checks above leave
        raise ValueError(f"K4 refused B*H={b * h}, Dh={dh}, Tp={tp}: more "
                         f"than 65535 (batch row, head) pairs, or a Tp "
                         f"whose sixteenth part is longer than {K4_SPAN} "
                         f"positions")
    _build.check(err, "cross_attention_decode_bf16")
    _build.count(globals(), "k4_launch_count")
    return out


def cross_attention_decode_q8(q: torch.Tensor, kq: QKV, vq: QKV
                              ) -> torch.Tensor:
    """K5: single-query cross-attention over int8 cross-KV.

    ``q``: (B, H, 1, Dh), rounded to bf16 in the kernel's place;
    ``kq``: {"q": (B, H, Dh, Tp) int8, "s": (B, H, Tp) f32};
    ``vq``: {"q": (B, H, Tp, Dh) int8, "s": (B, H, Tp) f32}; a zero scale
    masks its position. Tp % 16 == 0 and 16-byte aligned K, V and scales
    (the kernel's bulk copies), as ``quantize_cross_kv`` lays them out.
    Returns (B, H, 1, Dh) f32."""
    _build.no_autograd("K5", q, kq, vq)
    if q.device.type == "cpu":
        return cross_attention_decode_q8_plain(q, kq, vq)
    b, h, dh = _check_decode(q, "cross_attention_decode_q8")
    tp = kq["q"].shape[-1]
    if (kq["q"].dtype != torch.int8 or vq["q"].dtype != torch.int8
            or tuple(kq["q"].shape) != (b, h, dh, tp)
            or tuple(vq["q"].shape) != (b, h, tp, dh)
            or tuple(kq["s"].shape) != (b, h, tp)
            or tuple(vq["s"].shape) != (b, h, tp) or tp % K5_STEP):
        raise ValueError(
            f"K5 takes int8 kq (B, H, Dh, Tp), vq (B, H, Tp, Dh) and f32 "
            f"(B, H, Tp) scales with Tp % {K5_STEP} == 0; got "
            f"{tuple(kq['q'].shape)} {kq['q'].dtype}, "
            f"{tuple(vq['q'].shape)} {vq['q'].dtype}")
    lib = _build.load("cross_attention_decode", _SIG)
    # every converted tensor stays in a name until the launch has returned
    f32 = lambda z: z.to(torch.float32).contiguous()
    qb = q.to(torch.bfloat16).contiguous()
    kqq, vqq = kq["q"].contiguous(), vq["q"].contiguous()
    ks, vs = f32(kq["s"]), f32(vq["s"])
    ptrs = [z.data_ptr() for z in (qb, kqq, ks, vqq, vs)]
    if any(p % 16 for p in ptrs[1:]):
        raise ValueError("K5 takes K, V and scales on 16-byte boundaries "
                         "(its TMA and bulk copies)")
    out = torch.empty((b, h, 1, dh), dtype=torch.float32, device=q.device)
    # the raw stream query, as K6's wrapper: the decode loop's host time is
    # its cost
    err = lib.nwt_xattn_decode_q8(
        *ptrs, out.data_ptr(), b * h, dh, tp,
        ctypes.c_float(float(dh) ** -0.5),
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if err == 1:   # cudaErrorInvalidValue: what the checks above leave
        raise ValueError(f"K5 refused B*H={b * h}, Dh={dh}, Tp={tp}: more "
                         f"than 65535 (batch row, head) pairs, or a Tp "
                         f"whose sixteenth part no block's shared memory "
                         f"holds")
    _build.check(err, "cross_attention_decode_q8")
    _build.count(globals(), "k5_launch_count")
    return out
