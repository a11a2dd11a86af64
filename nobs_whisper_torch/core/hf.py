"""HuggingFace-format Whisper checkpoint ingestion (port of
``core/hf.py``): a transformers-style state dict or safetensors file into
the stacked parameter tree, as torch tensors. The safetensors reader is
self-contained (header JSON + raw little-endian blobs): it needs no
``safetensors`` package. So is the writer beside it, with a reader that
maps the file and loads each tensor straight to a device, which the
port's native snapshots (``core/native_ckpt.py``) use.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import WhisperConfig, config_from_hparams


def config_from_hf(hf_config: Any) -> WhisperConfig:
    """Build a WhisperConfig from a transformers WhisperConfig object."""
    return config_from_hparams(
        n_vocab=hf_config.vocab_size,
        n_audio_ctx=hf_config.max_source_positions,
        n_audio_state=hf_config.d_model,
        n_audio_head=hf_config.encoder_attention_heads,
        n_audio_layer=hf_config.encoder_layers,
        n_text_ctx=hf_config.max_target_positions,
        n_text_state=hf_config.d_model,
        n_text_head=hf_config.decoder_attention_heads,
        n_text_layer=hf_config.decoder_layers,
        n_mels=hf_config.num_mel_bins,
    )


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def params_from_hf_state_dict(
    sd: Mapping[str, Any],
    cfg: WhisperConfig,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> Dict[str, Any]:
    """transformers Whisper state dict -> stacked param tree.

    Accepts both bare ``model.encoder...`` and ``encoder...`` key prefixes.
    torch linear weights are (d_out, d_in); ours are (d_in, d_out).
    """
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def g(name, transpose=False):
        a = _np(sd[name])
        return a.T if transpose else a

    def to_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    def stack(fmt, n, transpose=False):
        return to_t(np.stack([g(fmt.format(i=i), transpose)
                              for i in range(n)]))

    ne, nd = cfg.n_audio_layer, cfg.n_text_layer

    def blocks(side, n, cross):
        p = f"{side}.layers.{{i}}"
        out = {
            "ln1_g": stack(f"{p}.self_attn_layer_norm.weight", n),
            "ln1_b": stack(f"{p}.self_attn_layer_norm.bias", n),
            "q_w": stack(f"{p}.self_attn.q_proj.weight", n, True),
            "q_b": stack(f"{p}.self_attn.q_proj.bias", n),
            "k_w": stack(f"{p}.self_attn.k_proj.weight", n, True),
            "v_w": stack(f"{p}.self_attn.v_proj.weight", n, True),
            "v_b": stack(f"{p}.self_attn.v_proj.bias", n),
            "o_w": stack(f"{p}.self_attn.out_proj.weight", n, True),
            "o_b": stack(f"{p}.self_attn.out_proj.bias", n),
            "ln2_g": stack(f"{p}.final_layer_norm.weight", n),
            "ln2_b": stack(f"{p}.final_layer_norm.bias", n),
            "fc1_w": stack(f"{p}.fc1.weight", n, True),
            "fc1_b": stack(f"{p}.fc1.bias", n),
            "fc2_w": stack(f"{p}.fc2.weight", n, True),
            "fc2_b": stack(f"{p}.fc2.bias", n),
        }
        if cross:
            out.update({
                "lnx_g": stack(f"{p}.encoder_attn_layer_norm.weight", n),
                "lnx_b": stack(f"{p}.encoder_attn_layer_norm.bias", n),
                "xq_w": stack(f"{p}.encoder_attn.q_proj.weight", n, True),
                "xq_b": stack(f"{p}.encoder_attn.q_proj.bias", n),
                "xk_w": stack(f"{p}.encoder_attn.k_proj.weight", n, True),
                "xv_w": stack(f"{p}.encoder_attn.v_proj.weight", n, True),
                "xv_b": stack(f"{p}.encoder_attn.v_proj.bias", n),
                "xo_w": stack(f"{p}.encoder_attn.out_proj.weight", n, True),
                "xo_b": stack(f"{p}.encoder_attn.out_proj.bias", n),
            })
        return out

    def j(name, transpose=False):
        return to_t(g(name, transpose))

    return {
        "encoder": {
            # torch conv weight (d_out, c_in, k) -> (k, c_in, d_out)
            "conv1_w": to_t(np.transpose(g("encoder.conv1.weight"),
                                         (2, 1, 0))),
            "conv1_b": j("encoder.conv1.bias"),
            "conv2_w": to_t(np.transpose(g("encoder.conv2.weight"),
                                         (2, 1, 0))),
            "conv2_b": j("encoder.conv2.bias"),
            "pos": j("encoder.embed_positions.weight"),
            "blocks": blocks("encoder", ne, cross=False),
            "ln_post_g": j("encoder.layer_norm.weight"),
            "ln_post_b": j("encoder.layer_norm.bias"),
        },
        "decoder": {
            "tok_emb": j("decoder.embed_tokens.weight"),
            "pos": j("decoder.embed_positions.weight"),
            "blocks": blocks("decoder", nd, cross=True),
            "ln_g": j("decoder.layer_norm.weight"),
            "ln_b": j("decoder.layer_norm.bias"),
        },
    }


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Minimal safetensors reader (header JSON + raw little-endian blobs)."""
    import json
    import struct

    _DTYPES = {
        "F32": np.float32, "F16": np.float16, "BF16": None,
        "I64": np.int64, "I32": np.int32,
    }
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = 8 + hlen
    # mmap the blob: a large-v3 f16 file is ~3 GB; f.read() plus a
    # float32 upcast of every tensor tripled transient host RAM
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=base)
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        raw = data[start:end]
        dt = meta["dtype"]
        if dt == "BF16":
            u16 = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
            arr = u16.view(np.float32)
        else:
            arr = np.frombuffer(raw, dtype=_DTYPES[dt])
        out[name] = arr.reshape(meta["shape"]).astype(np.float32)
    return out


# safetensors dtype names <-> torch dtypes (the ones a parameter tree holds)
ST_DTYPES = {"F32": torch.float32, "BF16": torch.bfloat16,
             "F16": torch.float16, "I8": torch.int8, "I32": torch.int32,
             "I64": torch.int64, "U8": torch.uint8}
_ST_NAMES = {v: k for k, v in ST_DTYPES.items()}


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write a safetensors file: an 8-byte little-endian header length,
    the JSON header (padded with spaces to a multiple of 8), then the
    blobs back to back with no holes. Tensors go in order of falling
    element size and then name, so that each blob starts on a multiple of
    its element size. Written to a temporary name, then renamed."""
    import json
    import os
    import struct

    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    off = 0
    for name, t in items:
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            c = t.detach().to("cpu").contiguous()
            # bytes as stored (bf16 has no numpy dtype: view as int16)
            f.write(c.view(torch.uint8).numpy().tobytes() if c.numel()
                    else b"")
    os.replace(tmp, path)


def load_safetensors_to(path: str, device="cpu"
                        ) -> Dict[str, torch.Tensor]:
    """Read a safetensors file of the dtypes in :data:`ST_DTYPES` into
    torch tensors on ``device``, in the stored dtypes. The file is mapped
    (copy-on-write, never written) and each tensor copied from the map to
    its device, so no host copy of the whole file is made."""
    import json
    import mmap
    import struct

    out: Dict[str, torch.Tensor] = {}
    dev = torch.device(device)
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + hlen
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        start, end = meta["data_offsets"]
        dt = ST_DTYPES[meta["dtype"]]
        n = (end - start) // torch.empty((), dtype=dt).element_size()
        t = (torch.frombuffer(mm, dtype=dt, count=n, offset=base + start)
             if n else torch.empty(0, dtype=dt)).reshape(meta["shape"])
        # a CPU result must not keep the map alive: clone it there
        out[name] = t.clone() if dev.type == "cpu" else t.to(dev)
    return out
