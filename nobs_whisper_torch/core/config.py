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


# ---------------------------------------------------------------------------
# Uni-MoE-2.0-Omni's audio-to-text path: a Whisper encoder (the tower)
# feeding a decoder-only language model whose FFN is a dynamic-capacity
# mixture of experts (models/uni_moe.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UniMoEConfig:
    """Static description of a speech LM: the Whisper ``tower`` (only its
    encoder fields are read), the connector's ``audio_tokens`` a 30 s
    window, and the language model. Each FFN holds ``n_routed`` routed
    SwiGLU experts of ``expert_width``, ``n_null`` zero-compute experts
    and ``n_shared`` shared experts of ``shared_width``; a token takes
    the shortest prefix of its sorted gate probabilities that reaches
    ``top_p``, at most ``top_k`` experts. Special ids: ``endoftext`` and
    the chat and audio markers after it (Qwen2's layout)."""

    name: str
    tower: WhisperConfig
    audio_tokens: int
    d_model: int
    n_layer: int
    n_head: int
    n_kv_head: int
    head_dim: int
    n_vocab: int
    n_routed: int
    n_null: int
    expert_width: int
    n_shared: int
    shared_width: int
    top_p: float
    top_k: int
    rope_theta: float
    rms_eps: float
    n_ctx: int = 2048            # positions the decode loop may reach
    endoftext: int = 151643

    @property
    def im_start(self) -> int:
        return self.endoftext + 1

    @property
    def im_end(self) -> int:
        return self.endoftext + 2

    @property
    def audio_start(self) -> int:
        return self.endoftext + 3

    @property
    def audio_end(self) -> int:
        return self.endoftext + 4

    @property
    def audio_pad(self) -> int:
        return self.endoftext + 5

    @property
    def stop_ids(self) -> tuple:
        """Greedy decoding stops at either."""
        return (self.im_end, self.endoftext)

    @property
    def eot(self) -> int:
        """The id a finished row keeps emitting, and the prompts' pad."""
        return self.endoftext

    @property
    def n_audio_ctx(self) -> int:
        return self.tower.n_audio_ctx

    @property
    def n_mels(self) -> int:
        return self.tower.n_mels

    @property
    def n_experts(self) -> int:
        """Routed and null: the gate's outputs."""
        return self.n_routed + self.n_null


def uni_moe_config_from_hparams(model: dict) -> UniMoEConfig:
    """A speech LM's configuration from its model file: the published
    ``config.json`` keys of the language model (``hidden_size``,
    ``num_hidden_layers``, ``mlp_dynamic_*``, ...), ``endoftext`` (the
    first special id) and ``tower``, the Whisper encoder's Hugging Face
    keys."""
    t = model["tower"]
    tower = config_from_hparams(
        n_vocab=51866, n_audio_ctx=t["max_source_positions"],
        n_audio_state=t["d_model"], n_audio_head=t["encoder_attention_heads"],
        n_audio_layer=t["encoder_layers"], n_text_ctx=448,
        n_text_state=t["d_model"], n_text_head=t["encoder_attention_heads"],
        n_text_layer=0, n_mels=t["num_mel_bins"])
    d, h = model["hidden_size"], model["num_attention_heads"]
    return UniMoEConfig(
        name=model.get("name", "uni-moe"), tower=tower,
        audio_tokens=model["whisper_query_tokens_size"], d_model=d,
        n_layer=model["num_hidden_layers"], n_head=h,
        n_kv_head=model["num_key_value_heads"], head_dim=d // h,
        n_vocab=model["vocab_size"],
        n_routed=model["mlp_dynamic_expert_num"],
        n_null=model["mlp_dynamic_null_expert_num"],
        expert_width=model["dynamic_intermediate_size"],
        n_shared=model["mlp_fixed_expert_num"],
        shared_width=model["shared_intermediate_size"],
        top_p=model["mlp_dynamic_top_p"], top_k=model["mlp_dynamic_top_k"],
        rope_theta=float(model["rope_theta"]),
        rms_eps=model["rms_norm_eps"], endoftext=model["endoftext"])
