"""Top-level engine API (port of ``api.py``): model loading (GGML, HF
snapshots or random weights), int8 quantization for serving, a truncated
encoder context, single-call and chunked transcription with prompt
biasing, and the post-hoc hallucination filter — on PyTorch, on the card
unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .audio.mel import HOP_LENGTH, log_mel_longform
from .core.config import CONFIGS, WhisperConfig, get_config
from .core.device import resolve_device
from .core.tokenizer import WhisperTokenizer
from .decode.hallucination import filter_hallucinations
from .decode.rules import DecodeOptions
from .pipeline.longform import TranscribeResult, transcribe_mel
from .utils.profiling import stage_timer

log = logging.getLogger(__name__)


class NoModelError(RuntimeError):
    """Raised when transcribe is called before a model is loaded."""


def _load_alignment_heads_sidecar(model_path: str):
    """GGML files carry no DTW head metadata (whisper.cpp selects a
    built-in preset by model type); read an optional JSON sidecar
    ``<model>.alignment_heads.json`` — a [[layer, head], ...] list —
    written by the user or a conversion tool."""
    import json
    import os

    sidecar = os.path.splitext(model_path)[0] + ".alignment_heads.json"
    if not os.path.exists(sidecar):
        return None
    try:
        with open(sidecar) as f:
            raw = json.load(f)
        return [(int(l), int(h)) for l, h in raw]
    except (ValueError, TypeError, OSError) as e:
        log.warning("ignoring bad alignment-heads sidecar %s: %s",
                    sidecar, e)
        return None


@dataclasses.dataclass
class WhisperEngine:
    params: Optional[Any] = None
    cfg: Optional[WhisperConfig] = None
    tokenizer: Optional[WhisperTokenizer] = None
    compute_dtype: Any = torch.float32
    model_path: Optional[str] = None
    # tuned (layer, head) word-timestamp alignment heads from checkpoint
    # metadata (HF generation_config.json, or a ``<model>.alignment_heads
    # .json`` sidecar next to a GGML file); None = heuristic fallback
    alignment_heads: Optional[List[tuple]] = None
    # the card unless the caller asks for the CPU (resolve_device raises
    # when there is no card)
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device("cuda"))

    # ------------------------------------------------------------------
    # loading
    # ------------------------------------------------------------------
    @classmethod
    def from_ggml(cls, path: str, dtype=torch.bfloat16,
                  device="cuda") -> "WhisperEngine":
        """Load a whisper.cpp GGML checkpoint."""
        from .core.ggml import read_ggml
        from .models.whisper import params_from_ggml

        dev = resolve_device(device)
        t0 = time.perf_counter()
        ckpt = read_ggml(path)
        params = params_from_ggml(ckpt, dtype=dtype, device=dev)
        tokenizer = WhisperTokenizer(ckpt.vocab, ckpt.config)
        log.info("loaded GGML model %s in %.2fs", path,
                 time.perf_counter() - t0)
        return cls(params=params, cfg=ckpt.config, tokenizer=tokenizer,
                   compute_dtype=dtype, model_path=path, device=dev,
                   alignment_heads=_load_alignment_heads_sidecar(path))

    @classmethod
    def from_hf_dir(cls, path: str, dtype=torch.bfloat16,
                    vocab: Optional[List[bytes]] = None,
                    device="cuda") -> "WhisperEngine":
        """Load a transformers-format snapshot dir (config.json +
        model.safetensors). The HF tokenizer files don't carry the raw
        byte-level ranks directly, so ``vocab`` (id -> bytes, as embedded
        in GGML files) may be supplied; without it the engine transcribes
        but exposes no tokenizer-dependent features."""
        import json
        import os

        from .core.config import config_from_hparams
        from .core.hf import load_safetensors, params_from_hf_state_dict

        dev = resolve_device(device)
        with open(os.path.join(path, "config.json")) as f:
            hf = json.load(f)
        cfg = config_from_hparams(
            n_vocab=hf["vocab_size"],
            n_audio_ctx=hf["max_source_positions"],
            n_audio_state=hf["d_model"],
            n_audio_head=hf["encoder_attention_heads"],
            n_audio_layer=hf["encoder_layers"],
            n_text_ctx=hf["max_target_positions"],
            n_text_state=hf["d_model"],
            n_text_head=hf["decoder_attention_heads"],
            n_text_layer=hf["decoder_layers"],
            n_mels=hf["num_mel_bins"],
            name=os.path.basename(os.path.normpath(path)))
        sd = load_safetensors(os.path.join(path, "model.safetensors"))
        params = params_from_hf_state_dict(sd, cfg, dtype=dtype, device=dev)
        tokenizer = WhisperTokenizer(vocab, cfg) if vocab else None
        # HF snapshots ship the model's tuned DTW alignment heads in
        # generation_config.json (e.g. openai/whisper-large-v3-turbo)
        heads = None
        gen_path = os.path.join(path, "generation_config.json")
        if os.path.exists(gen_path):
            with open(gen_path) as f:
                gen = json.load(f)
            raw = gen.get("alignment_heads")
            if raw:
                heads = [(int(l), int(h)) for l, h in raw]
        return cls(params=params, cfg=cfg, tokenizer=tokenizer,
                   compute_dtype=dtype, model_path=path,
                   alignment_heads=heads, device=dev)

    @classmethod
    def from_random(cls, model: str = "tiny", dtype=torch.bfloat16,
                    seed: int = 0, device="cuda") -> "WhisperEngine":
        """Random weights from ``seed`` (tests and benchmarks). Unlike the
        reference, every config gets a synthetic byte-level vocab
        (``utils/testing.py::byte_level_vocab``), so a random model of any
        width can serve text end to end."""
        from .models.whisper import init_params
        from .utils.testing import byte_level_vocab, tiny_test_config

        dev = resolve_device(device)
        cfg = get_config(model) if model in CONFIGS else tiny_test_config()
        params = init_params(seed, cfg, dtype=dtype, device=dev)
        tokenizer = WhisperTokenizer(byte_level_vocab(cfg), cfg)
        return cls(params=params, cfg=cfg, tokenizer=tokenizer,
                   compute_dtype=dtype, device=dev)

    def quantize(self, encoder: bool = True) -> "WhisperEngine":
        """Return an engine on the int8 serving path: int8 decoder weights
        and, by default, the dynamic-int8 encoder (K1 attention at bf16
        compute where heads pair, K2 MLP at any compute dtype:
        ``models/whisper.py::encoder_kernel_gates``)."""
        from .ops.quant import quantize_decoder_params, quantize_encoder_params

        self._require_model()
        params = quantize_decoder_params(self.params)
        if encoder:
            params = quantize_encoder_params(params)
        return dataclasses.replace(self, params=params)

    def with_audio_ctx(self, audio_ctx: int) -> "WhisperEngine":
        """Return an engine with a truncated encoder context (whisper.cpp's
        ``wparams.audio_ctx``): every window becomes ``audio_ctx * 0.02``
        seconds, the encoder runs on the first ``2*audio_ctx`` mel frames
        with the first ``audio_ctx`` rows of the position table, and
        decode reads proportionally less cross-KV. Engine-level, as in the
        reference: one context per engine keeps the window batcher's
        packing uniform."""
        self._require_model()
        n_pos = self.params["encoder"]["pos"].shape[0]
        if not (0 < audio_ctx <= n_pos):
            raise ValueError(
                f"audio_ctx must be in (0, {n_pos}], got {audio_ctx}")
        if audio_ctx == self.cfg.n_audio_ctx:
            return self
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, n_audio_ctx=audio_ctx))

    @property
    def loaded(self) -> bool:
        return self.params is not None

    def _require_model(self):
        if not self.loaded:
            raise NoModelError("no model loaded")

    # ------------------------------------------------------------------
    # transcription
    # ------------------------------------------------------------------
    def build_initial_prompt(self, vocabulary: Optional[str],
                             context: Optional[str]) -> Optional[List[int]]:
        """initial_prompt = "<vocabulary> <context>" / vocabulary / context."""
        parts = [p.strip() for p in (vocabulary, context) if p and p.strip()]
        if not parts:
            return None
        return self.tokenizer.encode(" " + " ".join(parts).strip())

    def transcribe(self, audio: np.ndarray, language: Optional[str] = None,
                   vocabulary: Optional[str] = None,
                   context: Optional[str] = None, task: Optional[str] = None,
                   opts: Optional[DecodeOptions] = None) -> TranscribeResult:
        """Transcribe (or translate) 16 kHz f32 PCM; ``language=None``
        defers to ``opts.language``, ``"auto"`` forces detection."""
        self._require_model()
        base = opts or DecodeOptions()
        if language == "auto":
            lang = None
        elif language is None:
            lang = base.language
        else:
            lang = language
        opts = dataclasses.replace(
            base, task=task if task is not None else base.task,
            language=lang)

        audio = np.asarray(audio, dtype=np.float32)
        with stage_timer("mel"):
            mel = log_mel_longform(audio, n_mels=self.cfg.n_mels,
                                   device=self.device)
        content_frames = audio.shape[0] // HOP_LENGTH
        result = transcribe_mel(
            self.params, mel, content_frames, self.cfg, self.tokenizer,
            opts, initial_prompt_tokens=self.build_initial_prompt(
                vocabulary, context),
            compute_dtype=self.compute_dtype, device=self.device,
            alignment_heads=self.alignment_heads)
        return TranscribeResult(text=filter_hallucinations(result.text),
                                segments=result.segments,
                                language=result.language)

    def transcribe_chunked(
        self,
        chunks: Sequence[np.ndarray],
        language: Optional[str] = None,
        vocabulary: Optional[str] = None,
        opts: Optional[DecodeOptions] = None,
    ) -> str:
        """Sequential chunk transcription with rolling text context: chunk
        N's transcript becomes chunk N+1's context (its prompt, through
        ``WhisperTokenizer.encode``); results joined with spaces; a chunk
        that fails is logged and skipped."""
        self._require_model()
        results: List[str] = []
        rolling: Optional[str] = None
        for i, chunk in enumerate(chunks):
            try:
                r = self.transcribe(chunk, language=language,
                                    vocabulary=vocabulary, context=rolling,
                                    opts=opts)
            except Exception:  # per-chunk error isolation, as the reference
                log.exception("chunk %d failed; skipping", i)
                continue
            if r.text:
                results.append(r.text)
                rolling = r.text
        return " ".join(results)
