"""Model architecture configs for the Whisper family.

TPU-native rebuild of the model ladder the reference exposes through its
12-entry GGML registry (reference: src-tauri/src/model.rs:50-188). The
reference delegates architecture knowledge to whisper.cpp; here the dims are
first-class so JAX can build static-shape programs per variant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# Audio front-end constants (Whisper-fixed; reference inherits them from
# whisper.cpp and targets 16 kHz at src-tauri/src/audio.rs:7).
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS          # 480_000 samples / window
N_FRAMES = N_SAMPLES // HOP_LENGTH               # 3000 mel frames / window


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    """Static architecture description of one Whisper variant."""

    name: str
    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int
    # Number of language tokens in the vocab. 99 for v1/v2-era vocabs,
    # 100 for large-v3-era vocabs (adds yue).
    n_langs: int = 99
    # Overrides for synthetic/test vocabs; real checkpoints derive these
    # from n_vocab.
    eot_id: Optional[int] = None
    force_multilingual: Optional[bool] = None

    @property
    def multilingual(self) -> bool:
        if self.force_multilingual is not None:
            return self.force_multilingual
        # English-only checkpoints use the 51864-token vocab.
        return self.n_vocab >= 51865

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head

    @property
    def ffn_dim(self) -> int:
        return 4 * self.n_audio_state

    # ---- special token ids (derived; mirrors openai-whisper tokenizer) ----
    @property
    def eot(self) -> int:
        if self.eot_id is not None:
            return self.eot_id
        return 50257 if self.multilingual else 50256

    @property
    def sot(self) -> int:
        return self.eot + 1

    @property
    def lang_base(self) -> int:
        """Token id of the first language token (<|en|>)."""
        return self.sot + 1

    @property
    def translate(self) -> int:
        return self.lang_base + self.n_langs

    @property
    def transcribe(self) -> int:
        return self.translate + 1

    @property
    def sot_lm(self) -> int:
        return self.transcribe + 1

    @property
    def sot_prev(self) -> int:
        return self.sot_lm + 1

    @property
    def no_speech(self) -> int:
        return self.sot_prev + 1

    @property
    def no_timestamps(self) -> int:
        return self.no_speech + 1

    @property
    def timestamp_begin(self) -> int:
        """Token id of <|0.00|>; timestamps run to <|30.00|> in 20 ms steps."""
        return self.no_timestamps + 1

    @property
    def n_timestamps(self) -> int:
        return self.n_vocab - self.timestamp_begin


def _cfg(name, n_mels, n_vocab, d, heads, enc_layers, dec_layers, n_langs=99):
    return WhisperConfig(
        name=name,
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_ctx=1500,
        n_audio_state=d,
        n_audio_head=heads,
        n_audio_layer=enc_layers,
        n_text_ctx=448,
        n_text_state=d,
        n_text_head=heads,
        n_text_layer=dec_layers,
        n_langs=n_langs,
    )


# The full ladder exposed by the reference registry
# (src-tauri/src/model.rs:50-188): official tiny..large-v3-turbo, the
# Distil-Whisper trio, and the q5-quantized variants (same dims as their base).
CONFIGS: Dict[str, WhisperConfig] = {
    "tiny": _cfg("tiny", 80, 51865, 384, 6, 4, 4),
    "tiny.en": _cfg("tiny.en", 80, 51864, 384, 6, 4, 4),
    "base": _cfg("base", 80, 51865, 512, 8, 6, 6),
    "base.en": _cfg("base.en", 80, 51864, 512, 8, 6, 6),
    "small": _cfg("small", 80, 51865, 768, 12, 12, 12),
    "small.en": _cfg("small.en", 80, 51864, 768, 12, 12, 12),
    "medium": _cfg("medium", 80, 51865, 1024, 16, 24, 24),
    "medium.en": _cfg("medium.en", 80, 51864, 1024, 16, 24, 24),
    "large-v3": _cfg("large-v3", 128, 51866, 1280, 20, 32, 32, n_langs=100),
    "large-v3-turbo": _cfg("large-v3-turbo", 128, 51866, 1280, 20, 32, 4,
                           n_langs=100),
    "distil-small.en": _cfg("distil-small.en", 80, 51864, 768, 12, 12, 4),
    "distil-medium.en": _cfg("distil-medium.en", 80, 51864, 1024, 16, 24, 2),
    "distil-large-v3": _cfg("distil-large-v3", 128, 51866, 1280, 20, 32, 2,
                            n_langs=100),
    # Quantized registry entries share dims with their fp parents.
    "small-q5_1": _cfg("small-q5_1", 80, 51865, 768, 12, 12, 12),
    "medium-q5_0": _cfg("medium-q5_0", 80, 51865, 1024, 16, 24, 24),
    "large-v3-q5_0": _cfg("large-v3-q5_0", 128, 51866, 1280, 20, 32, 32,
                          n_langs=100),
}


def config_from_hparams(
    n_vocab: int,
    n_audio_ctx: int,
    n_audio_state: int,
    n_audio_head: int,
    n_audio_layer: int,
    n_text_ctx: int,
    n_text_state: int,
    n_text_head: int,
    n_text_layer: int,
    n_mels: int,
    name: Optional[str] = None,
) -> WhisperConfig:
    """Build a config directly from GGML header hparams (checkpoint-driven)."""
    n_langs = 100 if n_vocab == 51866 else 99
    return WhisperConfig(
        name=name or f"custom-{n_audio_state}d",
        n_mels=n_mels,
        n_vocab=n_vocab,
        n_audio_ctx=n_audio_ctx,
        n_audio_state=n_audio_state,
        n_audio_head=n_audio_head,
        n_audio_layer=n_audio_layer,
        n_text_ctx=n_text_ctx,
        n_text_state=n_text_state,
        n_text_head=n_text_head,
        n_text_layer=n_text_layer,
        n_langs=n_langs,
    )


def get_config(name: str) -> WhisperConfig:
    if name not in CONFIGS:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]
