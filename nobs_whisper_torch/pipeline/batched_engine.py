"""Engine wrapper routing window decodes through the shared batcher (port
of ``pipeline/batched_engine.py``): same surface as
``WhisperEngine.transcribe``, with single-window requests of concurrent
callers packed into one WindowBatcher batch and long files run window by
window through the same batcher."""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from ..audio.mel import HOP_LENGTH
from ..core.config import SAMPLE_RATE
from ..core.device import resolve_device
from ..decode.hallucination import filter_hallucinations
from ..decode.rules import (DecodeOptions, is_no_speech, needs_fallback,
                            token_entropy)
from .batcher import WindowBatcher
from .longform import (Segment, TranscribeResult, _submit_timeout,
                       _temperature_ladder)


class BatchedEngine:
    """Same surface as WhisperEngine.transcribe, batched across callers.

    Runs on the engine's device; ``device``, when given, must name that
    device (the engine's own default is the card). ``speculative``,
    ``draft_pool`` and ``draft_engine`` go to the batcher (exact
    speculative greedy; ``draft_engine`` a second-model draft, None = the
    target drafting for itself). ``mesh`` is a later slice of the port
    and raises."""

    def __init__(self, engine, opts: Optional[DecodeOptions] = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 device=None, mesh=None, speculative: int = 0,
                 draft_pool: Optional[int] = None, draft_engine=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving is not ported yet (ROADMAP.md queue 1, "
                "item 11)")
        if device is not None and resolve_device(device) != engine.device:
            raise ValueError(f"device {device} is not the engine's "
                             f"device {engine.device}")
        self.engine = engine
        self.opts = opts or DecodeOptions()
        # observability (/stats): single-window chunks served, the extra
        # rungs of the temperature-fallback ladder they took (each a full
        # batched window decode), and the tokens they emitted. Multi-window
        # files route through transcribe_mel and are not counted here.
        self._stats_lock = threading.Lock()
        self.chunk_count = 0
        self.fallback_retries = 0
        self.tokens_emitted = 0
        self.batcher = WindowBatcher(
            engine.params, engine.cfg, engine.tokenizer, self.opts,
            max_batch=max_batch, max_wait_ms=max_wait_ms,
            compute_dtype=engine.compute_dtype, device=engine.device,
            speculative=speculative, draft_pool=draft_pool,
            draft=(None if draft_engine is None
                   else (draft_engine.params, draft_engine.cfg)))

    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def tokenizer(self):
        return self.engine.tokenizer

    @property
    def loaded(self):
        return self.engine.loaded

    @property
    def model_path(self):
        # /health reports the serving model
        return getattr(self.engine, "model_path", None)

    def close(self):
        self.batcher.close()

    def warmup(self, **kw):
        """Run one batch of each size through the batcher before traffic
        (see ``WindowBatcher.warmup``)."""
        return self.batcher.warmup(**kw)

    def _transcribe_longform_batched(self, audio: np.ndarray,
                                     language: Optional[str],
                                     vocabulary: Optional[str],
                                     context: Optional[str]
                                     ) -> TranscribeResult:
        """Long-form with every window decode submitted to the batcher."""
        from ..audio.mel import log_mel_longform
        from ..utils.profiling import stage_timer
        from .longform import transcribe_mel

        eng = self.engine
        if language == "auto":
            lang = None
        elif language is None:
            lang = self.opts.language
        else:
            lang = language
        opts = dataclasses.replace(self.opts, language=lang)
        with stage_timer("mel"):
            mel = log_mel_longform(audio, n_mels=eng.cfg.n_mels,
                                   device=eng.device)
        content_frames = audio.shape[0] // HOP_LENGTH
        initial = eng.build_initial_prompt(vocabulary, context)
        result = transcribe_mel(
            eng.params, mel, content_frames, eng.cfg, eng.tokenizer, opts,
            initial_prompt_tokens=initial, compute_dtype=eng.compute_dtype,
            device=eng.device, batcher=self.batcher)
        return TranscribeResult(text=filter_hallucinations(result.text),
                                segments=result.segments,
                                language=result.language)

    def transcribe(self, audio: np.ndarray, language: Optional[str] = None,
                   vocabulary: Optional[str] = None,
                   context: Optional[str] = None,
                   task: Optional[str] = None,
                   opts: Optional[DecodeOptions] = None) -> TranscribeResult:
        if task is not None:
            opts = dataclasses.replace(opts or DecodeOptions(), task=task)
        cfg = self.engine.cfg
        audio = np.asarray(audio, dtype=np.float32)
        window_frames = 2 * cfg.n_audio_ctx
        content_frames = audio.shape[0] // HOP_LENGTH
        eff = opts if opts is not None else self.opts
        if content_frames > window_frames \
                or (opts is not None and opts != self.opts) \
                or (self.opts.best_of or 1) > 1:
            if content_frames > window_frames and eff == self.opts \
                    and not eff.word_timestamps \
                    and (eff.best_of or 1) <= 1:
                return self._transcribe_longform_batched(
                    audio, language, vocabulary, context)
            # custom options, word timestamps (they need the window's
            # encoder states) or best_of sampling: sequential path
            return self.engine.transcribe(audio, language=language,
                                          vocabulary=vocabulary,
                                          context=context, opts=eff)

        # main path: frame the chunk on the host; the batch then runs
        # frames -> mel -> encode -> decode on the card. Only the real-frame
        # prefix is sent (later rows are exactly zero and are re-padded).
        from ..audio.mel import frame_window_np, n_real_frames
        frames = frame_window_np(audio, n_frames=window_frames)
        frames = frames[: n_real_frames(len(audio), window_frames)]

        lang = language if language not in (None, "auto") else None
        prompt: List[int] = []
        initial = self.engine.build_initial_prompt(vocabulary, context)
        if initial:
            prompt.append(cfg.sot_prev)
            prompt.extend(initial[-(cfg.n_text_ctx // 2 - 1):])
        sot_pos = len(prompt)
        prompt.extend(self.engine.tokenizer.sot_sequence(
            language=(lang or "en") if cfg.multilingual else None,
            task=self.opts.task))
        lang_slot = (sot_pos + 1
                     if lang is None and cfg.multilingual else None)

        result, text = None, ""
        attempts = 0
        for temp in _temperature_ladder(self.opts):
            attempts += 1
            result = self.batcher.submit(
                None, prompt, temperature=temp, lang_slot=lang_slot,
                frames=frames).result(timeout=_submit_timeout())
            if lang_slot is not None and result.language:
                lang = result.language
                prompt[lang_slot] = self.engine.tokenizer.language_token(lang)
                lang_slot = None
            text = self.engine.tokenizer.decode(result.tokens)
            if not needs_fallback(result.avg_logprob,
                                  token_entropy(result.tokens),
                                  len(result.tokens), self.opts, text=text,
                                  no_speech_prob=result.no_speech_prob):
                break

        with self._stats_lock:
            self.chunk_count += 1
            self.fallback_retries += attempts - 1
            self.tokens_emitted += len(result.tokens)

        final_lang = lang or result.language or "en"
        if is_no_speech(result.no_speech_prob, result.avg_logprob,
                        self.opts):
            return TranscribeResult(text="", segments=[],
                                    language=final_lang)
        text = filter_hallucinations(text.strip())
        seg = Segment(
            id=0, seek=0, start=0.0,
            end=content_frames * HOP_LENGTH / SAMPLE_RATE,
            text=text, tokens=result.tokens,
            temperature=result.temperature,
            avg_logprob=result.avg_logprob,
            no_speech_prob=result.no_speech_prob)
        return TranscribeResult(text=text, segments=[seg] if text else [],
                                language=final_lang)
