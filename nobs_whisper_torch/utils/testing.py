"""Synthetic fixtures: tiny random checkpoints and audio signals.

The reference's tests never load a real model (SURVEY.md §4) — they test
pure logic against synthesized sine-wave audio. We go further: a fully
functional *tiny-random* Whisper checkpoint (real GGML bytes, real byte-level
BPE vocab, random weights) lets every subsystem — loader, tokenizer, mel,
encoder/decoder, decode loop, streaming — run end-to-end offline.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.config import WhisperConfig
from ..core import ggml
from ..audio.mel import mel_filter_bank


def tiny_test_config(
    n_vocab: int = 1000,
    n_audio_ctx: int = 64,
    d: int = 64,
    heads: int = 4,
    enc_layers: int = 2,
    dec_layers: int = 2,
    n_text_ctx: int = 96,
    n_mels: int = 80,
    multilingual: bool = True,
    n_langs: int = 4,
) -> WhisperConfig:
    """A miniature config whose special tokens sit at the top of a small
    vocab: [byte tokens ... eot sot langs.. translate transcribe sot_lm
    sot_prev no_speech no_timestamps timestamps...]."""
    n_timestamps = n_audio_ctx // 2 + 1
    n_specials = 1 + 1 + n_langs + 6 + n_timestamps
    eot_id = n_vocab - n_specials
    return WhisperConfig(
        name="tiny-random",
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_ctx=n_audio_ctx,
        n_audio_state=d,
        n_audio_head=heads,
        n_audio_layer=enc_layers,
        n_text_ctx=n_text_ctx,
        n_text_state=d,
        n_text_head=heads,
        n_text_layer=dec_layers,
        n_langs=n_langs,
        eot_id=eot_id,
        force_multilingual=multilingual,
    )


def byte_level_vocab(cfg: WhisperConfig, seed: int = 0) -> List[bytes]:
    """A miniature but *real* BPE vocab: 256 byte tokens first, then random
    merges of earlier tokens (so rank-order merging is exercised), then
    placeholder entries for the special-token id range."""
    rng = np.random.RandomState(seed)
    vocab: List[bytes] = [bytes([b]) for b in range(256)]
    seen = set(vocab)
    # deterministic useful merges for English-ish text
    for merge in [b" t", b"he", b" a", b"in", b" th", b"er", b" the", b"ing",
                  b" s", b" w", b"ou", b" he", b" o", b"re", b" i"]:
        if merge not in seen:
            vocab.append(merge)
            seen.add(merge)
    while len(vocab) < cfg.eot:
        a = vocab[rng.randint(0, len(vocab))]
        b = vocab[rng.randint(0, len(vocab))]
        cand = a + b
        if cand not in seen and len(cand) <= 8:
            vocab.append(cand)
            seen.add(cand)
    # special-token range with canonical markers so read_ggml can recover
    # the synthetic layout (real checkpoints derive specials from n_vocab)
    for i in range(cfg.eot, cfg.n_vocab):
        if i == cfg.eot:
            vocab.append(b"<|endoftext|>")
        elif i == cfg.timestamp_begin:
            vocab.append(b"<|0.00|>")
        else:
            vocab.append(f"[_special_{i}]".encode())
    return vocab


def random_ggml_tensors(cfg: WhisperConfig, seed: int = 0):
    """Random fp32 tensors in whisper.cpp GGML naming/layout."""
    rng = np.random.RandomState(seed)
    d = cfg.n_audio_state
    ffn = cfg.ffn_dim

    def w(*shape, scale=None):
        scale = scale if scale is not None else shape[-1] ** -0.5
        return (rng.randn(*shape) * scale).astype(np.float32)

    t = {}
    t["encoder.conv1.weight"] = w(d, cfg.n_mels, 3, scale=0.1)
    t["encoder.conv1.bias"] = w(d, scale=0.1)
    t["encoder.conv2.weight"] = w(d, d, 3, scale=0.05)
    t["encoder.conv2.bias"] = w(d, scale=0.1)
    from ..models.whisper import sinusoids
    t["encoder.positional_embedding"] = sinusoids(cfg.n_audio_ctx, d)
    t["encoder.ln_post.weight"] = np.ones(d, np.float32)
    t["encoder.ln_post.bias"] = np.zeros(d, np.float32)
    t["decoder.token_embedding.weight"] = w(cfg.n_vocab, d, scale=0.02)
    t["decoder.positional_embedding"] = w(cfg.n_text_ctx, d, scale=0.01)
    t["decoder.ln.weight"] = np.ones(d, np.float32)
    t["decoder.ln.bias"] = np.zeros(d, np.float32)

    def block(prefix, i, cross):
        b = f"{prefix}.blocks.{i}"
        t[f"{b}.attn_ln.weight"] = np.ones(d, np.float32)
        t[f"{b}.attn_ln.bias"] = np.zeros(d, np.float32)
        t[f"{b}.attn.query.weight"] = w(d, d)
        t[f"{b}.attn.query.bias"] = w(d, scale=0.02)
        t[f"{b}.attn.key.weight"] = w(d, d)
        t[f"{b}.attn.value.weight"] = w(d, d)
        t[f"{b}.attn.value.bias"] = w(d, scale=0.02)
        t[f"{b}.attn.out.weight"] = w(d, d)
        t[f"{b}.attn.out.bias"] = w(d, scale=0.02)
        t[f"{b}.mlp_ln.weight"] = np.ones(d, np.float32)
        t[f"{b}.mlp_ln.bias"] = np.zeros(d, np.float32)
        t[f"{b}.mlp.0.weight"] = w(ffn, d)
        t[f"{b}.mlp.0.bias"] = w(ffn, scale=0.02)
        t[f"{b}.mlp.2.weight"] = w(d, ffn)
        t[f"{b}.mlp.2.bias"] = w(d, scale=0.02)
        if cross:
            t[f"{b}.cross_attn_ln.weight"] = np.ones(d, np.float32)
            t[f"{b}.cross_attn_ln.bias"] = np.zeros(d, np.float32)
            t[f"{b}.cross_attn.query.weight"] = w(d, d)
            t[f"{b}.cross_attn.query.bias"] = w(d, scale=0.02)
            t[f"{b}.cross_attn.key.weight"] = w(d, d)
            t[f"{b}.cross_attn.value.weight"] = w(d, d)
            t[f"{b}.cross_attn.value.bias"] = w(d, scale=0.02)
            t[f"{b}.cross_attn.out.weight"] = w(d, d)
            t[f"{b}.cross_attn.out.bias"] = w(d, scale=0.02)

    for i in range(cfg.n_audio_layer):
        block("encoder", i, cross=False)
    for i in range(cfg.n_text_layer):
        block("decoder", i, cross=True)
    return t


def write_tiny_checkpoint(path: str, cfg: WhisperConfig = None,
                          seed: int = 0,
                          default_type: int = ggml.GGML_TYPE_F32
                          ) -> WhisperConfig:
    cfg = cfg or tiny_test_config()
    tensors = random_ggml_tensors(cfg, seed)
    vocab = byte_level_vocab(cfg, seed)
    mel = mel_filter_bank(cfg.n_mels)
    ggml.write_ggml(path, cfg, mel, vocab, tensors,
                    default_type=default_type)
    return cfg


def sine_audio(duration_s: float, freq: float = 440.0, amplitude: float = 0.3,
               sample_rate: int = 16000) -> np.ndarray:
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    return (amplitude * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def speech_like_audio(duration_s: float, seed: int = 0,
                      sample_rate: int = 16000) -> np.ndarray:
    """Band-limited noise bursts with pauses — VAD-exercising fixture."""
    rng = np.random.RandomState(seed)
    n = int(duration_s * sample_rate)
    out = np.zeros(n, np.float32)
    pos = 0
    while pos < n:
        burst = int(rng.uniform(0.3, 1.5) * sample_rate)
        gap = int(rng.uniform(0.2, 1.0) * sample_rate)
        seg = rng.randn(min(burst, n - pos)).astype(np.float32) * 0.2
        out[pos:pos + seg.size] = seg
        pos += burst + gap
    return out


def tone_burst_windows(b: int, seed: int) -> np.ndarray:
    """(b, 480000) f32 30 s windows: window i holds 3-27 s of noise bursts
    gated in half seconds over a tone of 300 + 100 i Hz, then zeros. For
    odd i the tone is a multiple of 40 Hz, on a bin of the 400-tap DFT:
    under the periodic Hann window it leaks into no far bin, so those bins
    hold only the quiet edges of the bursts, where an f32 DFT's rounding
    of the tone shows."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b, 480000), np.float32)
    for i in range(b):
        n = 16000 * (3 + 2 * (i % 13))
        out[i, :n] = 0.2 * rng.randn(n) * (rng.rand(n // 8000 + 1)
                                          .repeat(8000)[:n] > 0.4)
        out[i, :n] += 0.3 * np.sin(2 * np.pi * (300 + 100 * i)
                                   * np.arange(n) / 16000)
    return out


def _attention_variants(key, fuse_o=(False,)):
    from itertools import product
    return tuple("-".join([key] + ["o"] * o + ["i8s"] * s8 + ["i8pv"] * pv)
                 for o, s8, pv in product(fuse_o, (False, True),
                                          (False, True)))


class KernelSpies:
    """Count calls of the kernels' plain versions (what the wrappers run
    on CPU tensors) while the port runs on the CPU. ``patch`` is a setattr
    such as pytest's ``monkeypatch.setattr``, which undoes the spies after
    the test; ``calls`` maps each of ``kernels`` (by default the
    encoder's default ones: K1, K2, K3, K9) to its count. The attention
    kernels count by variant (``ops/encoder_attention.py::variant``):
    "K1" is the default K1 alone, "K1-o-i8s" K1 with the o projection
    fused and int8 scores, and so on."""

    NAMES = {"K1": ("ea", "encoder_attention_fused_qkv_plain"),
             "K3": ("ea", "encoder_attention_btd_plain"),
             "K12": ("fl", "encoder_layer_fused_plain"),
             "K9": ("ea", "encoder_attention_plain"),
             "K2": ("fm", "encoder_mlp_int8_resident_plain"),
             "K8": ("fm", "encoder_mlp_int8_plain"),
             "K10": ("fq", "encoder_qkv_int8_plain"),
             "K11": ("fq", "residual_o_int8_plain"),
             "K13": ("cs", "encoder_stem_fused_plain"),
             "K4": ("ap", "cross_attention_decode_bf16_plain"),
             "K5": ("ap", "cross_attention_decode_q8_plain"),
             "K6": ("qt", "q8_matmul_plain"),
             "K7": ("fm", "fused_mlp_q8_plain"),
             "K14": ("mp", "log10_mel_pallas_plain")}
    VARIANTS = {"K1": _attention_variants("K1", (False, True)),
                "K3": _attention_variants("K3"),
                "K12": _attention_variants("K12")}
    ENCODER = (VARIANTS["K1"] + ("K2",) + VARIANTS["K3"] + ("K8", "K9")
               + ("K10", "K11") + VARIANTS["K12"] + ("K13",))

    def __init__(self, patch, kernels=("K1", "K2", "K3", "K9")):
        from ..ops import attention_pallas as ap
        from ..ops import conv_stem as cs
        from ..ops import encoder_attention as ea
        from ..ops import fused_layer as fl
        from ..ops import fused_mlp as fm
        from ..ops import fused_qkv as fq
        from ..ops import mel_pallas as mp
        from ..ops import quant as qt
        mods = {"ea": ea, "fm": fm, "fq": fq, "cs": cs, "ap": ap, "qt": qt,
                "fl": fl, "mp": mp}
        self.calls = dict.fromkeys(kernels, 0)
        keys = {k.split("-")[0] for k in kernels}
        for key in keys:
            mod, name = self.NAMES[key]
            real = getattr(mods[mod], name)
            args = list(real.__code__.co_varnames[:real.__code__.co_argcount])

            def spy(*a, _key=key, _real=real, _args=args, **k):
                bound = dict(zip(_args, a), **k)
                name = _key if _key not in self.VARIANTS else ea.variant(
                    _key, _key == "K1" and bound.get("wo") is not None,
                    bool(bound.get("int8_scores")), bool(bound.get("int8_pv")))
                if name in self.calls:
                    self.calls[name] += 1
                return _real(*a, **k)
            patch(mods[mod], name, spy)
