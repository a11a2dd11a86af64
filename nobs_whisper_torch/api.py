"""Top-level engine API (port of ``api.py``): model loading (GGML or random
weights), int8 quantization for serving, single-call transcription with
prompt biasing, and the post-hoc hallucination filter — on PyTorch, on the
card unless the caller asks for the CPU."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, List, Optional

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


@dataclasses.dataclass
class WhisperEngine:
    params: Optional[Any] = None
    cfg: Optional[WhisperConfig] = None
    tokenizer: Optional[WhisperTokenizer] = None
    compute_dtype: Any = torch.float32
    model_path: Optional[str] = None
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
                   compute_dtype=dtype, model_path=path, device=dev)

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
        and, by default, the dynamic-int8 encoder (kernels K1 and K2).
        Raises NotImplementedError where the kernels cannot take the
        engine's compute dtype on its device."""
        from .models.whisper import encoder_kernel_gates
        from .ops.quant import quantize_decoder_params, quantize_encoder_params

        self._require_model()
        params = quantize_decoder_params(self.params)
        if encoder:
            params = quantize_encoder_params(params)
            encoder_kernel_gates(self.cfg, params["encoder"]["blocks"],
                                 self.compute_dtype, self.device)
        return dataclasses.replace(self, params=params)

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
            compute_dtype=self.compute_dtype, device=self.device)
        return TranscribeResult(text=filter_hallucinations(result.text),
                                segments=result.segments,
                                language=result.language)
