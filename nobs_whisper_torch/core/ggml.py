"""GGML ``ggml-*.bin`` Whisper checkpoint codec.

The reference consumes whisper.cpp GGML checkpoints (downloaded into
``~/.config/NobsWhisper/models/ggml-<id>.bin``, reference
src-tauri/src/model.rs:194, loaded via FFI at src-tauri/src/whisper.rs:41).
This module is a from-scratch NumPy implementation of that on-disk format so
the TPU framework can ingest the exact same model files: header hparams, mel
filterbank, embedded byte-level vocab, and tensors in f32/f16/q4_0/q4_1/
q5_0/q5_1/q8_0 encodings.

A writer is included so tests can fabricate tiny random checkpoints without
network access, and so the framework can emit quantized checkpoints itself.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import WhisperConfig, config_from_hparams

GGML_MAGIC = 0x67676D6C  # "ggml" (little-endian int32)

# ggml tensor dtypes (subset used by whisper.cpp checkpoints)
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8

QK = 32  # quantization block size (values per block)

# bytes per block of 32 values
_BLOCK_BYTES = {
    GGML_TYPE_Q4_0: 2 + 16,
    GGML_TYPE_Q4_1: 2 + 2 + 16,
    GGML_TYPE_Q5_0: 2 + 4 + 16,
    GGML_TYPE_Q5_1: 2 + 2 + 4 + 16,
    GGML_TYPE_Q8_0: 2 + 32,
}

TYPE_NAMES = {
    GGML_TYPE_F32: "f32",
    GGML_TYPE_F16: "f16",
    GGML_TYPE_Q4_0: "q4_0",
    GGML_TYPE_Q4_1: "q4_1",
    GGML_TYPE_Q5_0: "q5_0",
    GGML_TYPE_Q5_1: "q5_1",
    GGML_TYPE_Q8_0: "q8_0",
}


# --------------------------------------------------------------------------
# Dequantization (NumPy, vectorized). Shapes: raw block bytes -> float32.
# --------------------------------------------------------------------------

def _split_blocks(raw: bytes, block_bytes: int) -> np.ndarray:
    buf = np.frombuffer(raw, dtype=np.uint8)
    if buf.size % block_bytes:
        raise ValueError(
            f"quantized payload of {buf.size} bytes is not a multiple of "
            f"block size {block_bytes}")
    return buf.reshape(-1, block_bytes)


def _nibbles(qs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    lo = (qs & 0x0F).astype(np.int32)
    hi = (qs >> 4).astype(np.int32)
    return lo, hi


def _high_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nblocks, 4) uint8 -> (nblocks, 32) int32 of per-value 5th bits."""
    qh = qh_bytes.astype(np.uint32)
    qh32 = qh[:, 0] | (qh[:, 1] << 8) | (qh[:, 2] << 16) | (qh[:, 3] << 24)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh32[:, None] >> shifts[None, :]) & 1).astype(np.int32)


def dequant_q4_0(raw: bytes) -> np.ndarray:
    b = _split_blocks(raw, _BLOCK_BYTES[GGML_TYPE_Q4_0])
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)  # (n,1)
    lo, hi = _nibbles(b[:, 2:18])
    q = np.concatenate([lo, hi], axis=1).astype(np.float32) - 8.0
    return (q * d).reshape(-1)


def dequant_q4_1(raw: bytes) -> np.ndarray:
    b = _split_blocks(raw, _BLOCK_BYTES[GGML_TYPE_Q4_1])
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    lo, hi = _nibbles(b[:, 4:20])
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def dequant_q5_0(raw: bytes) -> np.ndarray:
    b = _split_blocks(raw, _BLOCK_BYTES[GGML_TYPE_Q5_0])
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    hb = _high_bits(b[:, 2:6])
    lo, hi = _nibbles(b[:, 6:22])
    q = np.concatenate([lo | (hb[:, :16] << 4), hi | (hb[:, 16:] << 4)],
                       axis=1).astype(np.float32) - 16.0
    return (q * d).reshape(-1)


def dequant_q5_1(raw: bytes) -> np.ndarray:
    b = _split_blocks(raw, _BLOCK_BYTES[GGML_TYPE_Q5_1])
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    hb = _high_bits(b[:, 4:8])
    lo, hi = _nibbles(b[:, 8:24])
    q = np.concatenate([lo | (hb[:, :16] << 4), hi | (hb[:, 16:] << 4)],
                       axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def dequant_q8_0(raw: bytes) -> np.ndarray:
    b = _split_blocks(raw, _BLOCK_BYTES[GGML_TYPE_Q8_0])
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    q = b[:, 2:34].copy().view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


_DEQUANT = {
    GGML_TYPE_Q4_0: dequant_q4_0,
    GGML_TYPE_Q4_1: dequant_q4_1,
    GGML_TYPE_Q5_0: dequant_q5_0,
    GGML_TYPE_Q5_1: dequant_q5_1,
    GGML_TYPE_Q8_0: dequant_q8_0,
}


# --------------------------------------------------------------------------
# Quantization (writer side; matches ggml reference rounding)
# --------------------------------------------------------------------------

def _blocked(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % QK:
        raise ValueError(f"size {x.size} not a multiple of {QK}")
    return x.reshape(-1, QK)


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per-block value with the largest magnitude, sign preserved."""
    idx = np.argmax(np.abs(xb), axis=1)
    return xb[np.arange(xb.shape[0]), idx]


def _pack_hb(q: np.ndarray) -> np.ndarray:
    """(n, 32) ints with 5th bit -> (n, 4) uint8 little-endian bitfield."""
    bits = ((q >> 4) & 1).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    qh32 = np.bitwise_or.reduce(bits << shifts[None, :], axis=1)
    out = np.empty((q.shape[0], 4), dtype=np.uint8)
    out[:, 0] = qh32 & 0xFF
    out[:, 1] = (qh32 >> 8) & 0xFF
    out[:, 2] = (qh32 >> 16) & 0xFF
    out[:, 3] = (qh32 >> 24) & 0xFF
    return out


def quantize_q4_0(x: np.ndarray) -> bytes:
    xb = _blocked(x)
    amax = _signed_absmax(xb)
    d = amax / -8.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor(xb * inv_d[:, None] + 8.5), 0, 15).astype(np.int32)
    out = np.empty((xb.shape[0], _BLOCK_BYTES[GGML_TYPE_Q4_0]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:18] = ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(
        np.uint8)
    return out.tobytes()


def quantize_q4_1(x: np.ndarray) -> bytes:
    xb = _blocked(x)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 15.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor((xb - mn[:, None]) * inv_d[:, None] + 0.5),
                0, 15).astype(np.int32)
    out = np.empty((xb.shape[0], _BLOCK_BYTES[GGML_TYPE_Q4_1]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:20] = ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(
        np.uint8)
    return out.tobytes()


def quantize_q5_0(x: np.ndarray) -> bytes:
    xb = _blocked(x)
    amax = _signed_absmax(xb)
    d = amax / -16.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor(xb * inv_d[:, None] + 16.5), 0, 31).astype(np.int32)
    d16 = d.astype(np.float16)
    lo = (q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)
    hb = _pack_hb(q)
    out = np.empty((xb.shape[0], _BLOCK_BYTES[GGML_TYPE_Q5_0]), dtype=np.uint8)
    out[:, 0:2] = d16[:, None].view(np.uint8)
    out[:, 2:6] = hb
    out[:, 6:22] = lo.astype(np.uint8)
    return out.tobytes()


def quantize_q5_1(x: np.ndarray) -> bytes:
    xb = _blocked(x)
    mn = xb.min(axis=1)
    mx = xb.max(axis=1)
    d = (mx - mn) / 31.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    q = np.clip(np.floor((xb - mn[:, None]) * inv_d[:, None] + 0.5),
                0, 31).astype(np.int32)
    out = np.empty((xb.shape[0], _BLOCK_BYTES[GGML_TYPE_Q5_1]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:4] = mn.astype(np.float16)[:, None].view(np.uint8)
    out[:, 4:8] = _pack_hb(q)
    out[:, 8:24] = ((q[:, :16] & 0x0F) | ((q[:, 16:] & 0x0F) << 4)).astype(
        np.uint8)
    return out.tobytes()


def quantize_q8_0(x: np.ndarray) -> bytes:
    xb = _blocked(x)
    amax = np.abs(xb).max(axis=1)
    d = amax / 127.0
    inv_d = np.where(d != 0.0, 1.0 / np.where(d == 0.0, 1.0, d), 0.0)
    # ggml's quantize_row_q8_0 uses roundf = half AWAY from zero;
    # np.round is banker's half-to-even and diverges at exact .5 steps
    v = xb * inv_d[:, None]
    q = np.clip(np.trunc(v + np.copysign(0.5, v)), -127, 127).astype(np.int8)
    out = np.empty((xb.shape[0], _BLOCK_BYTES[GGML_TYPE_Q8_0]), dtype=np.uint8)
    out[:, 0:2] = d.astype(np.float16)[:, None].view(np.uint8)
    out[:, 2:34] = q.view(np.uint8)
    return out.tobytes()


_QUANTIZE = {
    GGML_TYPE_Q4_0: quantize_q4_0,
    GGML_TYPE_Q4_1: quantize_q4_1,
    GGML_TYPE_Q5_0: quantize_q5_0,
    GGML_TYPE_Q5_1: quantize_q5_1,
    GGML_TYPE_Q8_0: quantize_q8_0,
}

# whisper.cpp reads the header ftype as a ggml_ftype and derives the
# default tensor wtype from it (ggml.h GGML_FTYPE_* codes) — writing 1
# (f16) for quantized checkpoints made them unloadable there
_FTYPE_CODES = {
    GGML_TYPE_F32: 0, GGML_TYPE_F16: 1,
    GGML_TYPE_Q4_0: 2, GGML_TYPE_Q4_1: 3,
    GGML_TYPE_Q8_0: 7, GGML_TYPE_Q5_0: 8, GGML_TYPE_Q5_1: 9,
}


# --------------------------------------------------------------------------
# Checkpoint container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class GGMLCheckpoint:
    config: WhisperConfig
    mel_filters: np.ndarray            # (n_mels, n_fft_bins) float32
    vocab: List[bytes]                 # id -> raw token bytes
    tensors: Dict[str, np.ndarray]     # name -> float32 array (numpy layout)
    tensor_types: Dict[str, int]       # name -> on-disk ggml type


def _tensor_nbytes(ttype: int, n_elems: int) -> int:
    if ttype == GGML_TYPE_F32:
        return 4 * n_elems
    if ttype == GGML_TYPE_F16:
        return 2 * n_elems
    bb = _BLOCK_BYTES.get(ttype)
    if bb is None:
        raise ValueError(f"GGML: unknown tensor type {ttype}")
    if n_elems % QK:
        raise ValueError(f"quantized tensor with {n_elems} elems not /{QK}")
    return (n_elems // QK) * bb


def read_ggml(path: str) -> GGMLCheckpoint:
    """Parse a whisper.cpp GGML checkpoint into fp32 NumPy tensors.

    Tensor arrays are returned in NumPy layout with shape = reversed ggml
    ``ne`` (ggml lists the contiguous dimension first).
    """
    # memmap, not read(): full file bytes + an fp32 upcast of every
    # tensor held simultaneously tripled transient host RAM on large-v3
    # (~10 GB); the mmap pages in per tensor and the OS drops cold
    # pages. Same reason core/hf.py memmaps safetensors.
    try:
        data = np.memmap(path, dtype=np.uint8, mode="r")
    except ValueError:
        raise ValueError(f"{path}: empty or unreadable GGML file")
    size = len(data)
    off = 0

    # every length/count below is validated against the file size before
    # use: a corrupt or truncated upload must yield a clean ValueError,
    # never a struct.error, a hang (negative length walking the cursor
    # backwards), or an unbounded allocation (fuzz hardening; the
    # reference's analogous hygiene is partial-download cleanup,
    # src-tauri/src/model.rs:287)
    def u32(what: str = "field") -> int:
        nonlocal off
        if off + 4 > size:
            raise ValueError(f"GGML: truncated file (reading {what})")
        (v,) = struct.unpack_from("<i", data, off)
        off += 4
        return v

    def take(n: int, what: str) -> np.ndarray:
        nonlocal off
        if n < 0:
            raise ValueError(f"GGML: negative {what} length {n}")
        if off + n > size:
            raise ValueError(f"GGML: truncated file (reading {what})")
        raw = data[off:off + n]
        off += n
        return raw

    if size < 4:
        raise ValueError(f"{path}: not a GGML file (too short)")
    magic = struct.unpack_from("<I", data, 0)[0]
    off = 4
    if magic != GGML_MAGIC:
        raise ValueError(f"{path}: bad magic {magic:#x}")

    hp = [u32("hparams") for _ in range(11)]
    (n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
     n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels,
     _ftype) = hp
    if any(v < 0 for v in hp[:10]) or any(v > (1 << 24) for v in hp[:10]):
        raise ValueError(f"GGML: implausible hparams {hp[:10]}")
    cfg = config_from_hparams(
        n_vocab, n_audio_ctx, n_audio_state, n_audio_head, n_audio_layer,
        n_text_ctx, n_text_state, n_text_head, n_text_layer, n_mels)

    # mel filterbank
    f_mels = u32("mel dims")
    f_fft = u32("mel dims")
    if f_mels < 0 or f_fft < 0:
        raise ValueError("GGML: negative mel filterbank dims")
    raw = take(4 * f_mels * f_fft, "mel filterbank")
    mel = np.frombuffer(raw, dtype="<f4").reshape(f_mels, f_fft).copy()

    # vocab: file may contain fewer tokens than header n_vocab
    # (multilingual checkpoints); whisper.cpp pads the tail.
    n_tok = u32("vocab size")
    if n_tok < 0 or n_tok * 4 > size:
        raise ValueError(f"GGML: implausible vocab size {n_tok}")
    vocab: List[bytes] = []
    for _ in range(n_tok):
        ln = u32("token length")
        vocab.append(bytes(take(ln, "token")))
    for i in range(n_tok, n_vocab):
        vocab.append(f"[_extra_token_{i}]".encode())

    tensors: Dict[str, np.ndarray] = {}
    ttypes: Dict[str, int] = {}
    while off < size:
        n_dims = u32("tensor dims")
        name_len = u32("tensor name length")
        ttype = u32("tensor type")
        if not 1 <= n_dims <= 4:
            raise ValueError(f"GGML: implausible tensor rank {n_dims}")
        ne = [u32("tensor shape") for _ in range(n_dims)]
        if any(d < 0 for d in ne):
            raise ValueError(f"GGML: negative tensor dim in {ne}")
        name = bytes(take(name_len, "tensor name")).decode(
            "utf-8", errors="replace")
        # Python-int product: an int64 np.prod silently WRAPS for
        # hostile near-2^31 dims, which could alias a huge tensor to a
        # small plausible byte count and land the cursor mid-stream
        n_elems = 1
        for d in ne:
            n_elems *= d
        if n_elems > 2 * size:
            # even the densest packing (q4_0: 32 elems / 18 bytes) fits
            # under 2 elements per file byte
            raise ValueError(
                f"GGML: implausible tensor size {n_elems} for {name!r}")
        nbytes = _tensor_nbytes(ttype, n_elems)
        raw = take(nbytes, f"tensor {name!r}")
        if ttype == GGML_TYPE_F32:
            arr = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif ttype == GGML_TYPE_F16:
            arr = np.frombuffer(raw, dtype="<f2").astype(np.float32)
        else:
            arr = _DEQUANT[ttype](raw)
        # ggml ne is fastest-dim-first; numpy shape is the reverse.
        tensors[name] = arr.reshape(tuple(reversed(ne)))
        ttypes[name] = ttype

    # Synthetic small-vocab checkpoints embed canonical special markers;
    # recover their layout (real >=51864-token vocabs derive specials from
    # n_vocab and never hit this path).
    if n_vocab < 51864:
        try:
            eot_id = vocab.index(b"<|endoftext|>")
            tb = vocab.index(b"<|0.00|>")
            # layout: eot sot langs.. translate transcribe sot_lm sot_prev
            #         no_speech no_timestamps ts..
            n_langs = tb - eot_id - 8
            if n_langs > 0:
                cfg = dataclasses.replace(
                    cfg, eot_id=eot_id, n_langs=n_langs,
                    force_multilingual=True)
        except ValueError:
            pass

    return GGMLCheckpoint(config=cfg, mel_filters=mel, vocab=vocab,
                          tensors=tensors, tensor_types=ttypes)


def write_ggml(
    path: str,
    config: WhisperConfig,
    mel_filters: np.ndarray,
    vocab: List[bytes],
    tensors: Dict[str, np.ndarray],
    tensor_types: Optional[Dict[str, int]] = None,
    default_type: int = GGML_TYPE_F32,
) -> None:
    """Emit a whisper.cpp-compatible GGML checkpoint.

    ``tensors`` values are NumPy arrays (numpy layout); ``tensor_types``
    selects the on-disk encoding per tensor (1D tensors are always f32,
    mirroring whisper.cpp's quantizer which leaves norms/biases alone).
    """
    tensor_types = tensor_types or {}
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        ftype_header = _FTYPE_CODES[default_type]
        f.write(struct.pack(
            "<11i", config.n_vocab, config.n_audio_ctx,
            config.n_audio_state, config.n_audio_head, config.n_audio_layer,
            config.n_text_ctx, config.n_text_state, config.n_text_head,
            config.n_text_layer, config.n_mels, ftype_header))
        mf = np.ascontiguousarray(mel_filters, dtype="<f4")
        f.write(struct.pack("<2i", mf.shape[0], mf.shape[1]))
        f.write(mf.tobytes())
        f.write(struct.pack("<i", len(vocab)))
        for tok in vocab:
            f.write(struct.pack("<i", len(tok)))
            f.write(tok)
        for name, arr in tensors.items():
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            ttype = tensor_types.get(name, default_type)
            if ttype in _QUANTIZE and (arr.ndim != 2
                                       or arr.shape[-1] % QK):
                # whisper.cpp quantizes 2-D tensors only, and ggml
                # requires the contiguous dim ne[0] to be a QK multiple
                # (blocks may not span rows) — gating on total SIZE let
                # 3-wide conv kernels through with row-spanning blocks,
                # which its loader rejects
                ttype = GGML_TYPE_F32
            if arr.ndim == 1:
                ttype = GGML_TYPE_F32
            ne = list(reversed(arr.shape))
            name_b = name.encode("utf-8")
            f.write(struct.pack("<3i", len(ne), len(name_b), ttype))
            for d in ne:
                f.write(struct.pack("<i", d))
            f.write(name_b)
            if ttype == GGML_TYPE_F32:
                f.write(arr.astype("<f4").tobytes())
            elif ttype == GGML_TYPE_F16:
                f.write(arr.astype("<f2").tobytes())
            else:
                f.write(_QUANTIZE[ttype](arr))
