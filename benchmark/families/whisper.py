"""The Whisper family: configurations whose model file has Hugging Face's
Whisper keys (``d_model``, ``encoder_layers``, ``decoder_layers``,
``vocab_size``, ...), served by the program's ``WhisperEngine`` on
weights from ``weights.py`` and judged by ``reference/``. A configuration
that names no ``"family"`` is Whisper's. The functions are the interface
``harness.py`` lists."""

from __future__ import annotations

from typing import Dict, List, Optional

from benchmark.ops import arith
from benchmark.reference.tokens import Encoder, byte_level_vocab, layout


def vocabulary(model: dict):
    lay = layout(model["vocab_size"])
    vocab = byte_level_vocab(lay)
    return lay, vocab, Encoder(vocab, lay.eot)


def _dtype(model: dict):
    import torch
    return getattr(torch, model["serving"]["compute_dtype"])


def build_engine(cell, seed: int, vocab: List[bytes], device):
    """The program's engine on the benchmark's weights, made on the card
    from ``seed`` and quantized by the program as configured."""
    import torch
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.core.config import config_from_hparams
    from nobs_whisper_torch.core.tokenizer import WhisperTokenizer

    from benchmark.weights import make_tree
    m = cell.model
    cfg = config_from_hparams(
        n_vocab=m["vocab_size"], n_audio_ctx=m["max_source_positions"],
        n_audio_state=m["d_model"], n_audio_head=m["encoder_attention_heads"],
        n_audio_layer=m["encoder_layers"],
        n_text_ctx=m["max_target_positions"], n_text_state=m["d_model"],
        n_text_head=m["decoder_attention_heads"],
        n_text_layer=m["decoder_layers"], n_mels=m["num_mel_bins"],
        name=m["name"])
    dtype = _dtype(m)
    tree = make_tree(m, seed, cfg.eot, device, dtype=dtype)
    eng = WhisperEngine(params=tree, cfg=cfg,
                        tokenizer=WhisperTokenizer(vocab, cfg),
                        compute_dtype=dtype, device=torch.device(device))
    if m["serving"]["quantization"] == "int8":
        eng = eng.quantize()
    return eng


def judge(cell, sample: List[dict], seed: int, device,
          control_bits: Optional[int] = None) -> Dict:
    """``sample``: dicts with ``audio``, ``vocabulary``, ``context``,
    ``prompt`` and ``served`` (``reference/check.py::judge``)."""
    from benchmark.reference.check import judge as plain_judge
    from benchmark.weights import make_tree
    m = cell.model
    lay, _, enc = vocabulary(m)
    tree = make_tree(m, seed, lay.eot, device, dtype=_dtype(m))
    bits = 8 if m["serving"]["quantization"] == "int8" else None
    return plain_judge(tree, m, lay, enc, sample, device, bits=bits,
                       control_bits=control_bits)


def batch_least_s(model: dict, prompt_lens, steps: int) -> float:
    return arith.batch_least_s(model, prompt_lens, steps)


def encoder_blocks(model: dict):
    return model["d_model"], model["encoder_ffn_dim"], model["encoder_layers"]
