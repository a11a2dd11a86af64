"""Native checkpoint format: fast-load serving snapshots (port of
``core/native_ckpt.py``).

GGML files parse and dequantize on every load; for restarts the engine
can snapshot its ready-to-run state (the parameter tree with its int8
tensors, the config, the vocabulary) into a directory that loads straight
back to the device. ``meta.json`` is the reference's, key for key
(``config``, ``vocab_b64``, ``format_version``). The reference writes the
tree with orbax, which needs jax; the port writes it as one safetensors
file, ``params.safetensors``, with the writer in ``core/hf.py``: the tree
flattened by key path (``decoder.blocks.q_w.q``), int8 leaves kept as
their ``q``/``s`` pair, every leaf in its own dtype. The port does not
read the reference's orbax snapshots.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
from typing import Any, Dict, List, Tuple

import torch

from .config import WhisperConfig

PARAMS_FILE = "params.safetensors"
# derived copies the card's kernels keep in a QTensor (ops/quant.py::
# k_major): made again at first use, never saved
_DERIVED = {"qt"}


def flatten(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a": {"b": t}} -> {"a.b": t}, dropping derived leaves."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if k in _DERIVED:
            continue
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def save_native(path: str, params: Any, cfg: WhisperConfig,
                vocab: List[bytes]) -> None:
    from .hf import save_safetensors

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, PARAMS_FILE), flatten(params))
    meta = {
        "config": dataclasses.asdict(cfg),
        "vocab_b64": [base64.b64encode(t).decode() for t in vocab],
        "format_version": 1,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_native(path: str, device="cpu"
                ) -> Tuple[Any, WhisperConfig, List[bytes]]:
    """(params on ``device``, config, vocabulary) of a snapshot that
    :func:`save_native` wrote. Raises FileNotFoundError for a directory
    without the port's params file (the reference's orbax snapshots among
    them)."""
    from .hf import load_safetensors_to

    path = os.path.abspath(path)
    params_file = os.path.join(path, PARAMS_FILE)
    if not os.path.exists(params_file):
        raise FileNotFoundError(
            f"{path} holds no {PARAMS_FILE}: not a snapshot of this "
            "package's save_native (the JAX package's orbax snapshots "
            "are not read; convert from the GGML file instead)")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = WhisperConfig(**meta["config"])
    vocab = [base64.b64decode(t) for t in meta["vocab_b64"]]
    params = unflatten(load_safetensors_to(params_file, device))
    return params, cfg, vocab
