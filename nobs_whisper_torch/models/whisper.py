"""Whisper encoder/decoder in PyTorch (port of ``models/whisper.py``).

Parameters are the reference's nested dict, with torch tensors for leaves:
per-layer weights stacked along a leading layer axis, linear weights in the
(d_in, d_out) layout, int8 weights as ``{"q", "s"}`` QTensors. Matmuls run
in the compute dtype (bf16 on the card); LayerNorm, softmax and logits in
f32. Where the reference asks XLA for an f32 result of bf16 operands
(``preferred_element_type``), the port multiplies f32 copies of the bf16
values: their products are exact in f32.

The encoder takes the hand-written kernels under the gates and knobs of
the reference's single-device serving path, read at each call
(:func:`encoder_kernel_gates`): at bf16, attention through K1 (int8), K3
(float) or K9 (heads that do not pair), in ``ops/encoder_attention.py``;
the int8 MLP through K2 or K8 (``ops/fused_mlp.py``) at any compute dtype;
under the opt-in knobs K10/K11 (``ops/fused_qkv.py``) and K13
(``ops/conv_stem.py``). The decoder takes the
reference's opt-in decode kernels under its knobs, read at each call:
K6 (``ops/quant.py::q8_matmul``) in :func:`_dense`, K4 and K5
(``ops/attention_pallas.py``) in the cross-attention.
The decoder KV cache is updated in place (the reference's functional
``dynamic_update_slice`` writes the same slices).
"""

from __future__ import annotations

import collections
import math
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import WhisperConfig
from ..core.device import disable_tf32, scalar
from ..ops import _build
from ..ops import attention_pallas as ap
from ..parallel import tp as _tp
from ..ops.quant import (dense_int8_dynamic, is_quantized, k_major, ln_f32,
                         q8_matmul)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# weights from the JAX package (tests) — numpy trees in, torch trees out
# ---------------------------------------------------------------------------

def params_from_jax(tree, device="cpu", dtype=torch.float32) -> Params:
    """Carry a JAX parameter tree across as torch tensors.

    ``tree`` holds numpy arrays (``jax.tree.map(np.asarray, params)``, bf16
    leaves cast to f32 first). The (d_in, d_out) layout and the leading L
    axis are kept; QTensors keep int8 ``q`` and f32 ``s``; every other
    floating leaf becomes ``dtype``."""
    if isinstance(tree, dict):
        if is_quantized(tree):
            return {"q": torch.as_tensor(np.array(tree["q"], np.int8),
                                         device=device),
                    "s": torch.as_tensor(np.array(tree["s"], np.float32),
                                         device=device)}
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    t = torch.as_tensor(np.array(tree), device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked block dict (views, no copies; a QTensor's
    K-major copy ``"qt"`` too, where it has one)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if is_quantized(v)
                else v[i]) for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _layer_norm(x: torch.Tensor, g, b, eps: float = 1e-5) -> torch.Tensor:
    return ln_f32(x, g, b, eps).to(x.dtype)


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A constant rounded to ``like``'s dtype first, as the reference's
    weakly typed Python scalars and ``np...astype(x.dtype)`` constants are
    (a bare Python float would enter a bf16 op unrounded). Made once per
    value, dtype and device (``core/device.py::scalar``)."""
    return scalar(v, like.dtype, like.device)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) gelu as ``jax.nn.gelu(approximate=False)`` computes it:
    0.5 * x * erfc(-x * sqrt(1/2)), each op rounded to x.dtype."""
    return 0.5 * x * torch.erfc(-x * _const(math.sqrt(0.5), x))


def _gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """tanh-gelu for the bf16 serving path (the f32 path keeps exact erf).
    ``jax.nn.gelu(approximate=True)`` op by op, each op rounded to x.dtype
    and its constants in x.dtype, as the reference computes it; the fused
    ``F.gelu(approximate="tanh")`` rounds once and differs by one bf16
    step in ~40% of elements."""
    c, k = _const(math.sqrt(2 / math.pi), x), _const(0.044715, x)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    # (..., T, d) -> (..., n_head, T, d_head)
    *lead, t, d = x.shape
    return x.reshape(*lead, t, n_head, d // n_head).transpose(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # (..., n_head, T, d_head) -> (..., T, d)
    x = x.transpose(-2, -3)
    *lead, t, h, dh = x.shape
    return x.reshape(*lead, t, h * dh)


def _f32_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with f32 accumulation and an f32 result for bf16 or f32
    operands (``preferred_element_type=f32``)."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _softmax_pv(scores, v, mask):
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e9)
    probs = torch.softmax(scores, dim=-1)
    return probs.to(v.dtype) @ v


def _attention(q, k, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Heads-first attention. q,k,v: (..., H, T, Dh); mask broadcastable
    to (..., H, Tq, Tk), True = attend."""
    scale = _const(q.shape[-1] ** -0.25, q)
    scores = _f32_dot(q * scale, (k * scale).transpose(-1, -2))
    return _softmax_pv(scores, v, mask)


def _attention_kt(q, kT, v, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Attention over a pre-transposed K (..., H, Dh, Tk), the decode
    self-cache layout."""
    scale = _const(q.shape[-1] ** -0.25, q)
    scores = _f32_dot(q * scale, kT * scale)
    return _softmax_pv(scores, v, mask)


def _attention_kt_ancestry(q, kT, v, mask, ancestry: torch.Tensor,
                           beam_k: int) -> torch.Tensor:
    """Beam self-attention through ancestry pointers (``NWT_BEAM_ANCESTRY``):
    the cache is never permuted; ``ancestry[i, t]`` names the beam row of
    i's element whose KV at position t belongs to row i's history. Scores
    and PV are contractions over the K source rows with a one-hot ancestry
    mask, whose other terms are exact zeros: the same values as the
    permuted path up to f32 reassociation.

    q (BK, H, 1, Dh); kT (BK, H, Dh, T); v (BK, H, T, Dh);
    mask (BK, 1, 1, T); ancestry (BK, T) int in [0, beam_k)."""
    bk, h, s, dh = q.shape
    if s != 1:
        raise ValueError("ancestry attention is the single-token step path")
    b = bk // beam_k
    t = kT.shape[-1]
    scale = _const(dh ** -0.25, q)
    qg = (q * scale).reshape(b, beam_k, h, dh).float()
    kg = (kT * scale).reshape(b, beam_k, h, dh, t).float()
    vg = v.reshape(b, beam_k, h, t, dh)
    hot = F.one_hot(ancestry.reshape(b, beam_k, t).long(),
                    beam_k).float()                      # (B, Kq, T, Ks)
    s_all = torch.einsum("bqhd,bkhdt->bqkht", qg, kg)
    scores = torch.einsum("bqkht,bqtk->bqht", s_all, hot)
    if mask is not None:
        scores = scores.masked_fill(~mask.reshape(b, beam_k, 1, t), -1e9)
    probs = torch.softmax(scores, dim=-1)
    psel = torch.einsum("bqht,bqtk->bqkht", probs.to(v.dtype).float(), hot)
    out = torch.einsum("bqkht,bkhtd->bqhd", psel, vg.float()).to(v.dtype)
    return out.reshape(bk, h, 1, dh)


# ---------------------------------------------------------------------------
# decode-kernel gates: the reference's knobs (whisper.py:715-721, :799-804,
# :814-815) with the card in the TPU's place, read at each call; on the CPU
# the same gates choose the kernels' plain versions
# ---------------------------------------------------------------------------

Q8_KERNEL_MAX_M = 256   # K6 takes matmuls of at most this many rows


def q8_kernel_min_bytes() -> int:
    """K6's weight-size threshold: ``NWT_Q8_KERNEL_MIN_BYTES``, unset =
    2^62 (never)."""
    return int(os.environ.get("NWT_Q8_KERNEL_MIN_BYTES", 0) or (1 << 62))


def xattn_kernel_enabled() -> bool:
    """K4 on the packed bf16 cross-KV (``NWT_XATTN_KERNEL``; off in a
    plain shard, ``parallel/tp.py``)."""
    return bool(os.environ.get("NWT_XATTN_KERNEL")) and not _tp.kernels_off()


def q8_kv_kernel_enabled() -> bool:
    """K5 on the int8 cross-KV (``NWT_Q8_KV_PALLAS``; off in a plain
    shard)."""
    return bool(os.environ.get("NWT_Q8_KV_PALLAS")) and not _tp.kernels_off()


def _dense(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """Linear on plain or int8 weights. An int8 weight of at least
    :func:`q8_kernel_min_bytes` bytes met by at most 256 rows runs K6,
    whose f32 result returns to x.dtype (at f32 compute K6 still rounds x
    and the weights to bf16, as the TPU does); otherwise the reference's
    XLA path: dequant in the compute dtype, then matmul. The bias is added
    after, in x.dtype."""
    if is_quantized(w):
        lead = x.shape[:-1]
        m = math.prod(lead)
        if (m <= Q8_KERNEL_MAX_M and not _tp.kernels_off()
                and math.prod(w["q"].shape[-2:]) >= q8_kernel_min_bytes()):
            y = q8_matmul(x.reshape(m, x.shape[-1]), w)
            y = y.reshape(*lead, -1).to(x.dtype)
        else:
            y = x @ (w["q"].to(x.dtype) * w["s"].to(x.dtype))
    else:
        y = x @ w
    return y if b is None else y + b


def _dense_row(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """:func:`_dense` for a weight split over tp on its input features (o,
    xo, fc2): the ranks' partial products summed, then the bias once."""
    if _tp.tp_size() == 1:
        return _dense(x, w, b)
    return _tp.row_dense(x, w, b, _dense)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            stride: int) -> torch.Tensor:
    """x: (B, T, C_in); w: (K, C_in, C_out); pad 1 for K=3. Operands in
    x.dtype, f32 accumulation, bias added in f32, result in x.dtype."""
    y = F.conv1d(x.transpose(1, 2).to(torch.float32),
                 w.to(x.dtype).to(torch.float32).permute(2, 1, 0),
                 stride=stride, padding=1)
    return (y.transpose(1, 2) + b.to(torch.float32)).to(x.dtype)


class EncoderGates(NamedTuple):
    stem: Optional[str]        # "K13", or None: torch ops
    qkv: Optional[str]         # "K1"/"K12" (inside), "K10", or None
    attention: Optional[str]   # "K1", "K3", "K9", "K12", or None: torch ops
    o: Optional[str]           # "K1"/"K12" (fused), "K11", or None
    mlp: Optional[str]         # "K2", "K8", "K12" (inside), or None
    block_f: int               # the int8 MLP's fc2-input requant chunk
    block_q: int               # the T padding quantum (NWT_ATTN_BQ)
    int8_scores: bool = False  # K1/K3/K12's int8 QK^T (NWT_ATTN_I8)
    int8_pv: bool = False      # K1/K3/K12's int8 PV (NWT_ATTN_I8PV)


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported (ROADMAP.md queue 2, not queued); unset it "
        "to run the encoder's other kernels")


def encoder_kernel_gates(cfg: WhisperConfig, blocks, compute_dtype,
                         n_frames: Optional[int] = None,
                         pos_len: Optional[int] = None) -> EncoderGates:
    """What the encoder runs: the reference's single-device serving gates
    and knobs (whisper.py:266-353, :395-558), read at each call, with the
    card in the TPU's place; the CPU runs the same gates on the kernels'
    plain versions. ``n_frames`` and ``pos_len`` (the mel length and the
    position table's rows) default to a whole window.

    * Attention kernels need bf16 compute (``use_flash``, off with
      ``NWT_NO_FLASH``): the flat path where heads pair into 128 lanes
      (even head count, 2 * dh == 128), unless ``NWT_ATTN_BHTD``,
      ``NWT_INT8_QKV`` or ``NWT_LIB_FLASH`` turn it off. There: K12, the
      whole layer, with ``NWT_ATTN_FUSED`` >= 3, every linear of the layer
      quantized and the int8 MLP on (its chunk ``NWT_MLP_BF`` or 1280);
      else K1 for a quantized ``q_w`` (``NWT_ATTN_FUSED`` != 0), with the
      o projection fused for ``NWT_ATTN_FUSED`` >= 2 and a quantized
      ``o_w``; else LN, the projections and K3. ``NWT_ATTN_I8`` and
      ``NWT_ATTN_I8PV`` pick the int8 scores and PV of whichever of the
      three runs. Off the flat path K9 on split heads. At f32, LN, the
      projections and :func:`_attention` in torch ops.
    * ``NWT_INT8_QKV`` (any dtype): K10 for a quantized ``q_w`` and K11
      for a quantized ``o_w``.
    * The int8 MLP for a quantized ``fc1_w`` at a width that is a
      multiple of 128, at any compute dtype, unless ``NWT_NO_INT8_MLP``:
      K2, or K8 with ``NWT_MLP_CHUNKED``; ``NWT_MLP_BF`` sets the chunk.
    * ``NWT_STEM_FUSED`` at bf16: K13 for a width that is a multiple of
      128, an even mel length and a whole position table.

    Raises NotImplementedError where the reference would take the JAX
    library's flash kernel (``NWT_LIB_FLASH`` at bf16), which is not
    ported.

    In a plain shard (``parallel/tp.py``: tp > 1, or a dp mesh under
    ``NWT_NO_SPMD``) every gate is off, as the reference's gates are under
    GSPMD on more than one device."""
    env = os.environ.get
    d, n_head = cfg.n_audio_state, cfg.n_audio_head
    bf16 = compute_dtype == torch.bfloat16
    quant = {k: is_quantized(blocks[k])
             for k in ("q_w", "o_w", "fc1_w", "fc2_w")}
    use_flash = bf16 and not env("NWT_NO_FLASH")
    lib_flash = bool(env("NWT_LIB_FLASH"))
    int8_mlp = d % 128 == 0 and not env("NWT_NO_INT8_MLP")
    int8_qkv = bool(env("NWT_INT8_QKV"))
    use_btd = (use_flash and not lib_flash and not int8_qkv
               and n_head % 2 == 0 and 2 * (d // n_head) == 128
               and not env("NWT_ATTN_BHTD"))
    block_q = int(env("NWT_ATTN_BQ", 0)) or 256
    attn_fused = int(env("NWT_ATTN_FUSED", "1") or "0")
    chunked = bool(env("NWT_MLP_CHUNKED"))
    block_f = int(env("NWT_MLP_BF", 0)) or (1280 if chunked else 2560)
    o = "K11" if int8_qkv and quant["o_w"] else None
    mlp = (("K8" if chunked else "K2") if int8_mlp and quant["fc1_w"]
           else None)
    if _tp.kernels_off():
        return EncoderGates(stem=None, qkv=None, attention=None, o=None,
                            mlp=None, block_f=block_f, block_q=block_q)

    if use_btd and attn_fused >= 3 and all(quant.values()) and int8_mlp:
        # K12's own chunk (whisper.py:410), not K2's or K8's
        qkv = attention = o = mlp = "K12"
        block_f = int(env("NWT_MLP_BF", 0)) or 1280
    elif use_btd and attn_fused and quant["q_w"]:
        qkv = attention = "K1"
        if attn_fused >= 2 and quant["o_w"]:
            o = "K1"
    elif use_btd:
        qkv, attention = None, "K3"
    else:
        qkv = "K10" if int8_qkv and quant["q_w"] else None
        if use_flash and lib_flash:
            _unported("NWT_LIB_FLASH (the JAX library's flash kernel)")
        attention = "K9" if use_flash else None

    n_frames = n_frames or 2 * cfg.n_audio_ctx
    pos_len = pos_len or cfg.n_audio_ctx
    stem = ("K13" if bf16 and env("NWT_STEM_FUSED") and d % 128 == 0
            and n_frames % 2 == 0 and 2 * pos_len == n_frames else None)
    return EncoderGates(
        stem=stem, qkv=qkv, attention=attention, o=o, mlp=mlp,
        block_f=block_f, block_q=block_q,
        int8_scores=use_btd and bool(env("NWT_ATTN_I8")),
        int8_pv=use_btd and bool(env("NWT_ATTN_I8PV")))


encode_count = 0      # encoder batches run (each runs every layer once)


def k_major_weights(gates: EncoderGates) -> Tuple[str, ...]:
    """The stacked int8 weights that the gated kernels read K-major: K2's
    (K8's, K12's) fc1 and fc2; the q, k and v of K1, K12 and K10; the o
    of K1 with the o projection fused, K12 and K11. ``_encode`` makes each
    one's copy at its first call on the card and keeps it in the QTensor
    (``ops/quant.py::k_major``), which ``_layer`` slices with ``q``."""
    return ((("fc1_w", "fc2_w") if gates.mlp else ())
            + (("q_w", "k_w", "v_w") if gates.qkv else ())
            + (("o_w",) if gates.o else ()))


@torch.inference_mode()
def encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
           compute_dtype=torch.float32) -> torch.Tensor:
    """mel: (B, n_mels, 2*n_audio_ctx) -> (B, n_audio_ctx, d) states."""
    global encode_count
    disable_tf32()
    if _tp.is_lead():
        with _build.COUNT_LOCK:
            encode_count += 1
    return _encode(params, mel, cfg, compute_dtype)


def _encode(params: Params, mel: torch.Tensor, cfg: WhisperConfig,
            compute_dtype) -> torch.Tensor:
    """The reference's ``_encode`` (whisper.py:242-565) in its order."""
    from ..ops import conv_stem as cs
    from ..ops import encoder_attention as ea
    from ..ops import fused_layer as fl
    from ..ops import fused_mlp as fm
    from ..ops import fused_qkv as fq

    enc = params["encoder"]
    gelu = _gelu_fast if compute_dtype == torch.bfloat16 else _gelu
    n_head = _tp.local_heads(cfg.n_audio_head)   # a tp rank's heads
    blocks = enc["blocks"]
    gates = encoder_kernel_gates(cfg, blocks, compute_dtype, mel.shape[-1],
                                 enc["pos"].shape[0])
    flat = gates.attention in ("K1", "K3", "K12")
    # The attention kernels' T: padded keys are masked and padded rows
    # sliced off, once around the stack on the flat path (K1, K3, K12), around
    # each layer's attention for K9. The reference pads to a multiple of
    # NWT_ATTN_BQ; the card's kernels take T % 64 == 0, so the quantum is
    # rounded up to that (the rows past t_real never reach a real one).
    quantum = math.lcm(gates.block_q, 64)
    if gates.stem == "K13":
        t_real = mel.shape[-1] // 2
        align = quantum if flat else 8
        x = cs.encoder_stem_fused(mel, enc["conv1_w"], enc["conv1_b"],
                                  enc["conv2_w"], enc["conv2_b"], enc["pos"],
                                  -(-t_real // align) * align)
        if not flat:
            x = x[:, :t_real]
    else:
        x = mel.transpose(-1, -2).to(compute_dtype)          # (B, T, mels)
        x = gelu(_conv1d(x, enc["conv1_w"], enc["conv1_b"], stride=1))
        x = gelu(_conv1d(x, enc["conv2_w"], enc["conv2_b"], stride=2))
        x = x + enc["pos"][: x.shape[1]].to(compute_dtype)
        t_real = x.shape[1]
        if flat:
            x = F.pad(x, (0, 0, 0, -(-t_real // quantum) * quantum - t_real))
    bsz, t, d = x.shape
    head_pad = (0, 0, 0, -(-t_real // quantum) * quantum - t_real)

    def lin(h, w, bias=None):
        if is_quantized(w):
            return dense_int8_dynamic(h, w, bias)
        y = h @ w
        return y if bias is None else y + bias

    def row_lin(h, w, bias):
        # o and fc2: split over tp on their input features
        if _tp.tp_size() == 1:
            return lin(h, w, bias)
        if is_quantized(w):
            return _tp.row_dense_int8_dynamic(h, w, bias)
        return _tp.row_dense(h, w, bias, lambda a, z: a @ z)

    def rows(z):
        return z.reshape(bsz * t, d)

    sm_scale = float(d // cfg.n_audio_head) ** -0.5
    i8 = dict(int8_scores=gates.int8_scores, int8_pv=gates.int8_pv)
    if x.is_cuda:
        for name in k_major_weights(gates):
            k_major(blocks[name])
    for i in range(cfg.n_audio_layer):
        p = _layer(blocks, i)
        if gates.attention == "K12":
            x = fl.encoder_layer_fused(
                x, p["ln1_g"], p["ln1_b"], p["q_w"], p["q_b"], p["k_w"],
                p["v_w"], p["v_b"], p["o_w"], p["o_b"], p["ln2_g"],
                p["ln2_b"], p["fc1_w"], p["fc1_b"], p["fc2_w"], p["fc2_b"],
                t_real, sm_scale, n_head, block_f=gates.block_f, **i8)
            continue
        if gates.attention == "K1":
            fuse_o = gates.o == "K1"
            a = ea.encoder_attention_fused_qkv(
                x, p["ln1_g"], p["ln1_b"], p["q_w"], p["q_b"], p["k_w"],
                p["v_w"], p["v_b"], t_real, sm_scale, n_head,
                wo=p["o_w"] if fuse_o else None,
                bo=p["o_b"] if fuse_o else None, **i8)
        else:
            if gates.qkv == "K10":
                q, k, v = (z.reshape(bsz, t, d) for z in fq.encoder_qkv_int8(
                    rows(x), p["ln1_g"], p["ln1_b"], p["q_w"], p["q_b"],
                    p["k_w"], p["v_w"], p["v_b"]))
            else:
                h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
                q = lin(h, p["q_w"], p["q_b"])
                k = lin(h, p["k_w"])
                v = lin(h, p["v_w"], p["v_b"])
            if gates.attention == "K3":
                a = ea.encoder_attention_btd(q, k, v, t_real, sm_scale,
                                             n_head, **i8)
            elif gates.attention == "K9":
                a = ea.encoder_attention(
                    *(F.pad(_split_heads(z, n_head), head_pad)
                      for z in (q, k, v)), t_real, sm_scale)[..., :t_real, :]
                a = _merge_heads(a.to(x.dtype))
            else:
                a = _merge_heads(_attention(_split_heads(q, n_head),
                                            _split_heads(k, n_head),
                                            _split_heads(v, n_head),
                                            mask=None))
        if gates.o == "K1":
            x = a              # the residual and o projection are done
        elif gates.o == "K11":
            x = fq.residual_o_int8(rows(x), rows(a), p["o_w"],
                                   p["o_b"]).reshape(bsz, t, d)
        else:
            x = x + row_lin(a, p["o_w"], p["o_b"])
        if gates.mlp:
            mlp = (fm.encoder_mlp_int8 if gates.mlp == "K8"
                   else fm.encoder_mlp_int8_resident)
            x = mlp(rows(x), p["ln2_g"], p["ln2_b"], p["fc1_w"], p["fc1_b"],
                    p["fc2_w"], p["fc2_b"],
                    block_f=gates.block_f).reshape(bsz, t, d)
        else:
            h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
            h = gelu(lin(h, p["fc1_w"], p["fc1_b"]))
            x = x + row_lin(h, p["fc2_w"], p["fc2_b"])
    x = x[:, :t_real]
    return _layer_norm(x, enc["ln_post_g"], enc["ln_post_b"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def precompute_cross_kv(params: Params, xa: torch.Tensor, cfg: WhisperConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encoder states -> per-layer cross-attention K/V, each
    (L, B, H, T_audio, Dh). Computed once per window."""
    blocks = params["decoder"]["blocks"]
    n_head = _tp.local_heads(cfg.n_text_head)
    ks, vs = [], []
    for i in range(cfg.n_text_layer):
        p = _layer(blocks, i)
        ks.append(_split_heads(_dense(xa, p["xk_w"]), n_head))
        vs.append(_split_heads(_dense(xa, p["xv_w"], p["xv_b"]), n_head))
    return torch.stack(ks), torch.stack(vs)


def precompute_cross_kv_q8(params: Params, xa: torch.Tensor,
                           cfg: WhisperConfig):
    """Per-layer cross-KV projection and int8 quantization
    (``ops/attention_pallas.py::quant_kv_padded``): the same values as
    ``quantize_cross_kv(precompute_cross_kv(...))``, but only one layer's
    full-precision K/V exists at a time, which is what int8 cross-KV is
    for. Returns ({"q": (L, B, H, Dh, Tp) int8, "s": (L, B, H, Tp)},
    {"q": (L, B, H, Tp, Dh) int8, "s": (L, B, H, Tp)})."""
    blocks = params["decoder"]["blocks"]
    n_head = _tp.local_heads(cfg.n_text_head)
    kq, ks, vq, vs = [], [], [], []
    for i in range(cfg.n_text_layer):
        p = _layer(blocks, i)
        k8, k_s = ap.quant_kv_padded(
            _split_heads(_dense(xa, p["xk_w"]), n_head))
        v8, v_s = ap.quant_kv_padded(
            _split_heads(_dense(xa, p["xv_w"], p["xv_b"]), n_head))
        kq.append(k8.transpose(-1, -2))
        ks.append(k_s)
        vq.append(v8)
        vs.append(v_s)
    return ({"q": torch.stack(kq), "s": torch.stack(ks)},
            {"q": torch.stack(vq), "s": torch.stack(vs)})


def init_kv_cache(cfg: WhisperConfig, batch: int, dtype=torch.float32,
                  t_ctx: Optional[int] = None, device="cpu"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K pre-transposed (L, B, H, Dh, T), V (L, B, H, T, Dh); t_ctx
    defaults to the full text context. H is a tp rank's own heads."""
    t = t_ctx or cfg.n_text_ctx
    l, h, dh = (cfg.n_text_layer, _tp.local_heads(cfg.n_text_head),
                cfg.head_dim)
    return (torch.zeros((l, batch, h, dh, t), dtype=dtype, device=device),
            torch.zeros((l, batch, h, t, dh), dtype=dtype, device=device))


# decoder forwards run, by (cross-KV layout: "plain", "packed", "grouped"
# (beam rows over a packed cross-KV of fewer rows) or "q8", batch rows,
# tokens): with the gates above, what the decode kernels should launch
decoder_forward_calls: collections.Counter = collections.Counter()


def _cross_layout(xk, rows: int) -> str:
    if not isinstance(xk, dict):
        return "plain"
    if "kT" not in xk:
        return "q8"
    return "packed" if xk["kT"].shape[1] == rows else "grouped"


@torch.inference_mode()
def decoder_forward(params: Params, tokens: torch.Tensor,
                    cache_start: Union[int, torch.Tensor],
                    pad_lens: torch.Tensor, kv_cache, cross_kv,
                    cfg: WhisperConfig, compute_dtype=torch.float32,
                    ancestry: Optional[torch.Tensor] = None,
                    beam_k: int = 0,
                    pos_base: Optional[torch.Tensor] = None,
                    slot_mask: Optional[torch.Tensor] = None):
    """One decoder pass over S tokens (S=1 in the sampling loop, S=prompt
    length for prefill). Returns f32 logits (B, S, V) and the KV cache,
    whose slices [cache_start, cache_start+S) are written in place.
    ``cache_start`` is an int, or a 0-d long tensor on the tokens' device
    (the decode loop's step counter, which a CUDA graph of the step reads
    at each replay): the cache is then written by index, with the same
    values.

    Ragged batches are LEFT-padded: element b's sequence starts at cache
    index pad_lens[b]; position embeddings use the element's own position
    and self-attention masks the pad region.

    Speculative decoding (``decode/speculative.py``) keeps the uniform
    cache writes and leaves rejected draft slots in place: ``pos_base``
    (B,) replaces ``cache_idx - pad_lens`` as the position of the first
    token (clipped to the position table), and ``slot_mask`` (B, T_cache)
    bool masks the rejected slots out of self-attention. Both None: the
    plain pass, bit for bit.

    Beam search (``decode/beam.py``) runs B x K rows: on a packed cross-KV
    of B rows, K beams of an element share its cross-KV (the grouped
    cross-attention, never K4). Its ancestry mode passes ``ancestry``
    (B x K, T_cache) and ``beam_k``: rows never permute the cache, and
    self-attention reads each position's KV from its ancestor row
    (:func:`_attention_kt_ancestry`); S must be 1."""
    disable_tf32()
    dec = params["decoder"]
    n_head = _tp.local_heads(cfg.n_text_head)
    b, s = tokens.shape
    ck, cv = kv_cache
    xk, xv = cross_kv
    t_ctx = ck.shape[-1]
    dev = tokens.device
    if _tp.is_lead():
        _build.count(decoder_forward_calls, (_cross_layout(xk, b), b, s))

    cache_idx = cache_start + torch.arange(s, device=dev)            # (S,)
    if pos_base is None:
        pos_idx = torch.clamp(cache_idx[None, :] - pad_lens[:, None], 0,
                              cfg.n_text_ctx - 1)                     # (B, S)
    else:
        pos_idx = torch.clamp(pos_base[:, None] + torch.arange(
            s, device=dev)[None, :], 0, cfg.n_text_ctx - 1)
    x = (_tp.embed(dec["tok_emb"], tokens)
         + dec["pos"][pos_idx]).to(compute_dtype)

    key_idx = torch.arange(t_ctx, device=dev)[None, None, :]
    q_idx = cache_idx[None, :, None]
    self_mask = ((key_idx <= q_idx)
                 & (key_idx >= pad_lens[:, None, None]))[:, None]    # (B,1,S,T)
    if slot_mask is not None:
        self_mask = self_mask & slot_mask[:, None, None, :]

    def project_qkv(x, p):
        h = _layer_norm(x, p["ln1_g"], p["ln1_b"])
        if "qkv_w" in p:  # fused projection (ops.quant.fuse_qkv)
            qkv = _dense(h, p["qkv_w"], p["qkv_b"])
            return tuple(_split_heads(z, n_head)
                         for z in torch.chunk(qkv, 3, dim=-1))
        return (_split_heads(_dense(h, p["q_w"], p["q_b"]), n_head),
                _split_heads(_dense(h, p["k_w"]), n_head),
                _split_heads(_dense(h, p["v_w"], p["v_b"]), n_head))

    def cross_and_mlp(x, p, xk_l, xv_l):
        h = _layer_norm(x, p["lnx_g"], p["lnx_b"])
        q = _split_heads(_dense(h, p["xq_w"], p["xq_b"]), n_head)
        if isinstance(xk_l, dict) and "kT" in xk_l:
            packed = {"kT": xk_l["kT"], "v": xv_l["v"]}
            bq, bkv = q.shape[0], packed["kT"].shape[0]
            if bq != bkv:
                # beam search: G beams of an element share its cross-KV
                a = ap.cross_attention_kt_xla_grouped(
                    q.reshape(bkv, bq // bkv, *q.shape[1:]), packed,
                    cfg.n_audio_ctx).reshape(q.shape)
            elif q.shape[-2] == 1 and xattn_kernel_enabled():
                a = ap.cross_attention_decode_bf16(q, packed, cfg.n_audio_ctx)
            else:
                a = ap.cross_attention_kt_xla(q, packed, cfg.n_audio_ctx)
            a = a.to(compute_dtype)
        elif isinstance(xk_l, dict):
            if q.shape[-2] == 1 and q8_kv_kernel_enabled():
                a = ap.cross_attention_decode_q8(q, xk_l, xv_l)
            else:
                a = ap.cross_attention_dequant_reference(q, xk_l, xv_l)
            a = a.to(compute_dtype)
        else:
            a = _attention(q, xk_l.to(compute_dtype),
                           xv_l.to(compute_dtype), None)
        x = x + _dense_row(_merge_heads(a), p["xo_w"], p["xo_b"])
        h = _layer_norm(x, p["ln2_g"], p["ln2_b"])
        h = _gelu(_dense(h, p["fc1_w"], p["fc1_b"]))
        return x + _dense_row(h, p["fc2_w"], p["fc2_b"])

    for layer in range(cfg.n_text_layer):
        p = _layer(dec["blocks"], layer)
        q, k, v = project_qkv(x, p)
        k_new, v_new = k.transpose(-1, -2).to(ck.dtype), v.to(cv.dtype)
        if isinstance(cache_start, torch.Tensor):
            ck[layer].index_copy_(-1, cache_idx, k_new)
            cv[layer].index_copy_(-2, cache_idx, v_new)
        else:
            ck[layer, :, :, :, cache_start:cache_start + s] = k_new
            cv[layer, :, :, cache_start:cache_start + s, :] = v_new
        if ancestry is not None:
            a = _attention_kt_ancestry(
                q, ck[layer].to(compute_dtype), cv[layer].to(compute_dtype),
                self_mask, ancestry, beam_k)
        else:
            a = _attention_kt(q, ck[layer].to(compute_dtype),
                              cv[layer].to(compute_dtype), self_mask)
        x = x + _dense_row(_merge_heads(a), p["o_w"], p["o_b"])
        if isinstance(xk, dict):
            xk_l = {kk: vv[layer] for kk, vv in xk.items()}
            xv_l = {kk: vv[layer] for kk, vv in xv.items()}
        else:
            xk_l, xv_l = xk[layer], xv[layer]
        x = cross_and_mlp(x, p, xk_l, xv_l)
    x = _layer_norm(x, dec["ln_g"], dec["ln_b"])
    if "tok_emb_q" in dec:
        logits = _dense(x.to(torch.float32), dec["tok_emb_q"]).float()
    else:
        logits = _f32_dot(x, dec["tok_emb"].transpose(0, 1))
    return _tp.gather_vocab(logits), (ck, cv)


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------

def sinusoids(length: int, channels: int) -> np.ndarray:
    """Encoder positional embedding (identical to openai-whisper)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(10000) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment *
                            np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)


def init_params(seed: int, cfg: WhisperConfig, dtype=torch.float32,
                device="cpu") -> Params:
    """Random init with whisper-like scales (tests/benchmarks), drawn on
    the host with NumPy. The draws run in the reference's order from the
    same NumPy seed, so ``init_params(s, cfg)`` holds the same weights as
    the reference's ``init_params(PRNGKey(s), cfg)`` (its host RNG is
    seeded with the key's last word, = s)."""
    d = cfg.n_audio_state
    np_rng = np.random.RandomState(seed % (2**31 - 1))

    def nrm(shape, scale=None):
        scale = scale if scale is not None else shape[-1] ** -0.5
        arr = (np_rng.randn(*shape) * scale).astype(np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def enc_blocks(n_layer):
        ffn = cfg.ffn_dim
        return {
            "ln1_g": ones(n_layer, d), "ln1_b": zeros(n_layer, d),
            "q_w": nrm((n_layer, d, d)), "q_b": zeros(n_layer, d),
            "k_w": nrm((n_layer, d, d)),
            "v_w": nrm((n_layer, d, d)), "v_b": zeros(n_layer, d),
            "o_w": nrm((n_layer, d, d)), "o_b": zeros(n_layer, d),
            "ln2_g": ones(n_layer, d), "ln2_b": zeros(n_layer, d),
            "fc1_w": nrm((n_layer, d, ffn)), "fc1_b": zeros(n_layer, ffn),
            "fc2_w": nrm((n_layer, ffn, d)), "fc2_b": zeros(n_layer, d),
        }

    n_text = cfg.n_text_layer
    dec_extra = {
        "lnx_g": ones(n_text, d), "lnx_b": zeros(n_text, d),
        "xq_w": nrm((n_text, d, d)), "xq_b": zeros(n_text, d),
        "xk_w": nrm((n_text, d, d)),
        "xv_w": nrm((n_text, d, d)), "xv_b": zeros(n_text, d),
        "xo_w": nrm((n_text, d, d)), "xo_b": zeros(n_text, d),
    }
    return {
        "encoder": {
            "conv1_w": nrm((3, cfg.n_mels, d), scale=(3 * cfg.n_mels) ** -0.5),
            "conv1_b": zeros(d),
            "conv2_w": nrm((3, d, d), scale=(3 * d) ** -0.5),
            "conv2_b": zeros(d),
            "pos": torch.from_numpy(sinusoids(cfg.n_audio_ctx, d)).to(
                device=device, dtype=dtype),
            "blocks": enc_blocks(cfg.n_audio_layer),
            "ln_post_g": ones(d), "ln_post_b": zeros(d),
        },
        "decoder": {
            "tok_emb": nrm((cfg.n_vocab, d), scale=d ** -0.5),
            "pos": nrm((cfg.n_text_ctx, d), scale=0.01),
            "blocks": {**enc_blocks(n_text), **dec_extra},
            "ln_g": ones(d), "ln_b": zeros(d),
        },
    }


# ---- GGML name mapping ----------------------------------------------------

def params_from_ggml(ckpt, dtype=torch.float32, device="cpu") -> Params:
    """Map whisper.cpp GGML tensor names into the stacked param tree; GGML
    linear weights (d_out, d_in) are transposed to (d_in, d_out)."""
    t = ckpt.tensors
    cfg: WhisperConfig = ckpt.config

    def to_t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dtype)

    def blocks(prefix, n_layer, cross):
        def s(fmt, transpose=False):
            arrs = [t[fmt.format(prefix=prefix, i=i)] for i in range(n_layer)]
            return to_t(np.stack([a.T if transpose else a for a in arrs]))
        out = {
            "ln1_g": s("{prefix}.blocks.{i}.attn_ln.weight"),
            "ln1_b": s("{prefix}.blocks.{i}.attn_ln.bias"),
            "q_w": s("{prefix}.blocks.{i}.attn.query.weight", True),
            "q_b": s("{prefix}.blocks.{i}.attn.query.bias"),
            "k_w": s("{prefix}.blocks.{i}.attn.key.weight", True),
            "v_w": s("{prefix}.blocks.{i}.attn.value.weight", True),
            "v_b": s("{prefix}.blocks.{i}.attn.value.bias"),
            "o_w": s("{prefix}.blocks.{i}.attn.out.weight", True),
            "o_b": s("{prefix}.blocks.{i}.attn.out.bias"),
            "ln2_g": s("{prefix}.blocks.{i}.mlp_ln.weight"),
            "ln2_b": s("{prefix}.blocks.{i}.mlp_ln.bias"),
            "fc1_w": s("{prefix}.blocks.{i}.mlp.0.weight", True),
            "fc1_b": s("{prefix}.blocks.{i}.mlp.0.bias"),
            "fc2_w": s("{prefix}.blocks.{i}.mlp.2.weight", True),
            "fc2_b": s("{prefix}.blocks.{i}.mlp.2.bias"),
        }
        if cross:
            out.update({
                "lnx_g": s("{prefix}.blocks.{i}.cross_attn_ln.weight"),
                "lnx_b": s("{prefix}.blocks.{i}.cross_attn_ln.bias"),
                "xq_w": s("{prefix}.blocks.{i}.cross_attn.query.weight", True),
                "xq_b": s("{prefix}.blocks.{i}.cross_attn.query.bias"),
                "xk_w": s("{prefix}.blocks.{i}.cross_attn.key.weight", True),
                "xv_w": s("{prefix}.blocks.{i}.cross_attn.value.weight", True),
                "xv_b": s("{prefix}.blocks.{i}.cross_attn.value.bias"),
                "xo_w": s("{prefix}.blocks.{i}.cross_attn.out.weight", True),
                "xo_b": s("{prefix}.blocks.{i}.cross_attn.out.bias"),
            })
        return out

    def conv(name):   # GGML (d_out, c_in, k) -> ours (k, c_in, d_out)
        return to_t(np.transpose(t[name], (2, 1, 0)))

    return {
        "encoder": {
            "conv1_w": conv("encoder.conv1.weight"),
            "conv1_b": to_t(t["encoder.conv1.bias"]).reshape(-1),
            "conv2_w": conv("encoder.conv2.weight"),
            "conv2_b": to_t(t["encoder.conv2.bias"]).reshape(-1),
            "pos": to_t(t["encoder.positional_embedding"]),
            "blocks": blocks("encoder", cfg.n_audio_layer, cross=False),
            "ln_post_g": to_t(t["encoder.ln_post.weight"]),
            "ln_post_b": to_t(t["encoder.ln_post.bias"]),
        },
        "decoder": {
            "tok_emb": to_t(t["decoder.token_embedding.weight"]),
            "pos": to_t(t["decoder.positional_embedding"]),
            "blocks": blocks("decoder", cfg.n_text_layer, cross=True),
            "ln_g": to_t(t["decoder.ln.weight"]),
            "ln_b": to_t(t["decoder.ln.bias"]),
        },
    }


def params_to_ggml_tensors(params: Params,
                           cfg: WhisperConfig) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_ggml`: f32 numpy arrays named as
    whisper.cpp names them, linear weights in GGML's (d_out, d_in)
    layout, for ``core/ggml.py::write_ggml``. Takes an unquantized tree
    (int8 weights have no GGML f32 counterpart; dequantize first)."""
    out: Dict[str, np.ndarray] = {}

    def arr(t) -> np.ndarray:
        if is_quantized(t):
            raise ValueError("params_to_ggml_tensors takes unquantized "
                             "weights")
        return t.detach().to("cpu", torch.float32).numpy()

    def put(name, t, transpose=False):
        a = arr(t)
        out[name] = np.ascontiguousarray(a.T if transpose else a)

    enc, dec = params["encoder"], params["decoder"]
    # ours (k, c_in, d_out) -> GGML (d_out, c_in, k)
    out["encoder.conv1.weight"] = np.ascontiguousarray(
        np.transpose(arr(enc["conv1_w"]), (2, 1, 0)))
    put("encoder.conv1.bias", enc["conv1_b"])
    out["encoder.conv2.weight"] = np.ascontiguousarray(
        np.transpose(arr(enc["conv2_w"]), (2, 1, 0)))
    put("encoder.conv2.bias", enc["conv2_b"])
    put("encoder.positional_embedding", enc["pos"])
    put("encoder.ln_post.weight", enc["ln_post_g"])
    put("encoder.ln_post.bias", enc["ln_post_b"])
    put("decoder.token_embedding.weight", dec["tok_emb"])
    put("decoder.positional_embedding", dec["pos"])
    put("decoder.ln.weight", dec["ln_g"])
    put("decoder.ln.bias", dec["ln_b"])

    mapping = [
        ("ln1_g", "{p}.blocks.{i}.attn_ln.weight", False),
        ("ln1_b", "{p}.blocks.{i}.attn_ln.bias", False),
        ("q_w", "{p}.blocks.{i}.attn.query.weight", True),
        ("q_b", "{p}.blocks.{i}.attn.query.bias", False),
        ("k_w", "{p}.blocks.{i}.attn.key.weight", True),
        ("v_w", "{p}.blocks.{i}.attn.value.weight", True),
        ("v_b", "{p}.blocks.{i}.attn.value.bias", False),
        ("o_w", "{p}.blocks.{i}.attn.out.weight", True),
        ("o_b", "{p}.blocks.{i}.attn.out.bias", False),
        ("ln2_g", "{p}.blocks.{i}.mlp_ln.weight", False),
        ("ln2_b", "{p}.blocks.{i}.mlp_ln.bias", False),
        ("fc1_w", "{p}.blocks.{i}.mlp.0.weight", True),
        ("fc1_b", "{p}.blocks.{i}.mlp.0.bias", False),
        ("fc2_w", "{p}.blocks.{i}.mlp.2.weight", True),
        ("fc2_b", "{p}.blocks.{i}.mlp.2.bias", False),
    ]
    cross_mapping = [
        ("lnx_g", "{p}.blocks.{i}.cross_attn_ln.weight", False),
        ("lnx_b", "{p}.blocks.{i}.cross_attn_ln.bias", False),
        ("xq_w", "{p}.blocks.{i}.cross_attn.query.weight", True),
        ("xq_b", "{p}.blocks.{i}.cross_attn.query.bias", False),
        ("xk_w", "{p}.blocks.{i}.cross_attn.key.weight", True),
        ("xv_w", "{p}.blocks.{i}.cross_attn.value.weight", True),
        ("xv_b", "{p}.blocks.{i}.cross_attn.value.bias", False),
        ("xo_w", "{p}.blocks.{i}.cross_attn.out.weight", True),
        ("xo_b", "{p}.blocks.{i}.cross_attn.out.bias", False),
    ]
    for prefix, blocks, n_layer, maps in (
        ("encoder", enc["blocks"], cfg.n_audio_layer, mapping),
        ("decoder", dec["blocks"], cfg.n_text_layer,
         mapping + cross_mapping),
    ):
        for key, fmt, transpose in maps:
            stacked = arr(blocks[key])
            for i in range(n_layer):
                a = stacked[i]
                out[fmt.format(p=prefix, i=i)] = np.ascontiguousarray(
                    a.T if transpose else a)
    return out
