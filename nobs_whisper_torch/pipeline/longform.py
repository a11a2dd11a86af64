"""Long-form transcription: chained 30 s windows with rolling context
(port of ``pipeline/longform.py``): window decode -> temperature fallback
ladder -> no-speech gate -> timestamp-driven seek -> previous text as the
next window's prompt. With ``beam_size`` > 1 a window decodes by beam
search at temperature 0 and samples on the ladder's rungs above it. With
``word_timestamps`` each window's words are aligned by DTW
(``decode/timing.py``), partitioned over its segments by token ordinal,
and the segments' bounds snapped to their words."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import HOP_LENGTH, SAMPLE_RATE, WhisperConfig
from ..decode.beam import beam_decode_window
from ..decode.greedy import WindowResult, decode_window, detect_language
from ..decode.rules import (DecodeOptions, build_rule_tables, is_no_speech,
                            needs_fallback, token_entropy)

INPUT_STRIDE = 2            # mel frames per timestamp step
TIME_PRECISION = 0.02


@dataclasses.dataclass
class Segment:
    id: int
    seek: int                  # window start, mel frames
    start: float               # seconds
    end: float
    text: str
    tokens: List[int]          # includes timestamp tokens
    temperature: float
    avg_logprob: float
    no_speech_prob: float
    words: Optional[list] = None


@dataclasses.dataclass
class TranscribeResult:
    text: str
    segments: List[Segment]
    language: str


def _submit_timeout() -> float:
    from .batcher import submit_timeout_s
    return submit_timeout_s()


def _temperature_ladder(opts: DecodeOptions) -> List[float]:
    temps = [opts.temperature]
    if opts.temperature_increment:
        t = opts.temperature + opts.temperature_increment
        while t <= opts.max_temperature + 1e-9:
            temps.append(round(t, 10))
            t += opts.temperature_increment
    return temps


def decode_with_fallback(params, xa, prompt: Sequence[int],
                         cfg: WhisperConfig, tables, opts,
                         generator: Optional[torch.Generator] = None,
                         compute_dtype=torch.float32,
                         tokenizer=None) -> WindowResult:
    """Temperature ladder: retry the window while the quality gates fail;
    a window flagged as silence breaks the ladder at the first rung. At
    temperature 0 with beam_size > 1 the window decodes by beam search
    (openai/whisper.cpp: beam at zero temperature, sampling above it). At
    temperature > 0 with best_of > 1 the candidates are one tiled batch
    and the highest sum/len wins."""
    if generator is None:
        generator = torch.Generator(device=xa.device).manual_seed(0)
    result = None
    for temp in _temperature_ladder(opts):
        if temp == 0 and opts.beam_size and opts.beam_size > 1:
            result = beam_decode_window(
                params, xa, [prompt], cfg, tables,
                beam_size=opts.beam_size, sample_len=opts.sample_len,
                compute_dtype=compute_dtype)[0]
        elif temp > 0 and opts.best_of and opts.best_of > 1:
            xa_rep = xa.repeat_interleave(opts.best_of, dim=0)
            cands = decode_window(params, xa_rep, [prompt] * opts.best_of,
                                  cfg, tables, opts, temperature=temp,
                                  generator=generator,
                                  compute_dtype=compute_dtype)
            result = max(cands, key=lambda r: r.sum_logprob /
                         max(len(r.tokens), 1))
        else:
            result = decode_window(params, xa, [prompt], cfg, tables, opts,
                                   temperature=temp, generator=generator,
                                   compute_dtype=compute_dtype)[0]
        text = (tokenizer.decode(result.tokens)
                if tokenizer is not None else None)
        if not needs_fallback(result.avg_logprob,
                              token_entropy(result.tokens),
                              len(result.tokens), opts, text=text,
                              no_speech_prob=result.no_speech_prob):
            break
    return result


def _split_segments(tokens: List[int], tb: int, segment_size: int,
                    time_offset: float) -> Tuple[List[dict], int]:
    """openai-whisper's timestamp bookkeeping: slice a window's tokens into
    segments and compute the next seek position (mel frames)."""
    ts = [t >= tb for t in tokens]
    single_ts_ending = len(ts) >= 2 and ts[-1] and not ts[-2]
    consecutive = [i + 1 for i in range(len(tokens) - 1)
                   if ts[i] and ts[i + 1]]
    segments = []
    if consecutive:
        slices = list(consecutive)
        if single_ts_ending:
            slices.append(len(tokens))
        last = 0
        for cur in slices:
            part = tokens[last:cur]
            segments.append(dict(
                start=time_offset + (part[0] - tb) * TIME_PRECISION,
                end=time_offset + (part[-1] - tb) * TIME_PRECISION,
                tokens=part))
            last = cur
        if single_ts_ending:
            advance = segment_size
        else:
            advance = (tokens[last - 1] - tb) * INPUT_STRIDE
    else:
        duration = segment_size * HOP_LENGTH / SAMPLE_RATE
        ts_tokens = [t for t in tokens if t >= tb]
        if ts_tokens and ts_tokens[-1] != tb:
            duration = (ts_tokens[-1] - tb) * TIME_PRECISION
        segments.append(dict(start=time_offset,
                             end=time_offset + duration, tokens=tokens))
        advance = segment_size
    return segments, advance


def transcribe_mel(
    params,
    mel: np.ndarray,               # (n_mels, content_frames [+30 s pad])
    content_frames: int,
    cfg: WhisperConfig,
    tokenizer,
    opts: DecodeOptions,
    initial_prompt_tokens: Optional[Sequence[int]] = None,
    compute_dtype=torch.float32,
    device="cpu",
    generator: Optional[torch.Generator] = None,
    batcher=None,
    alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
) -> TranscribeResult:
    """Sequential window loop over a precomputed long-form mel.

    ``batcher``: an optional WindowBatcher; each window's decode is then
    submitted to it, so windows of concurrent callers share one device
    batch (the chain stays sequential per call: window N+1's prompt needs
    window N's text). Word timestamps need the window's encoder states,
    which the batcher keeps: they take the sequential path.

    ``alignment_heads``: the checkpoint's tuned (layer, head) list for the
    word-timestamp DTW; None = the upper-half-layers default."""
    if batcher is not None and (
            opts.word_timestamps or (opts.best_of or 1) > 1):
        raise ValueError("batched long-form supports neither "
                         "word_timestamps nor best_of>1; "
                         "use the sequential path")
    from ..models.whisper import encode
    from ..utils.profiling import stage_timer

    device = torch.device(device)
    tables = build_rule_tables(cfg, opts, tokenizer, device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    tb = cfg.timestamp_begin

    language = opts.language
    all_tokens: List[int] = []
    prompt_reset_since = 0
    if initial_prompt_tokens:
        all_tokens.extend(initial_prompt_tokens)

    window_frames = 2 * cfg.n_audio_ctx
    segments: List[Segment] = []
    seek = 0
    while seek < content_frames:
        segment_size = min(window_frames, content_frames - seek)
        window = mel[:, seek: seek + window_frames]
        if window.shape[1] < window_frames:
            window = np.pad(window,
                            ((0, 0), (0, window_frames - window.shape[1])))
        xa = None
        if batcher is None:
            with stage_timer("encode"):
                xa = encode(params, torch.from_numpy(
                    np.ascontiguousarray(window[None])).to(device), cfg,
                    compute_dtype)
            if language is None and cfg.multilingual:
                from ..core.tokenizer import LANGUAGES
                lang_idx, _ = detect_language(params, xa, cfg,
                                              compute_dtype)
                language = LANGUAGES[int(lang_idx[0])]
        lang = language or "en"

        prompt: List[int] = []
        if all_tokens[prompt_reset_since:]:
            prompt.append(cfg.sot_prev)
            prompt.extend(all_tokens[prompt_reset_since:]
                          [-(cfg.n_text_ctx // 2 - 1):])
        sot_pos = len(prompt)
        prompt.extend(tokenizer.sot_sequence(
            language=lang if cfg.multilingual else None,
            task=opts.task, timestamps=opts.timestamps))

        if batcher is None:
            with stage_timer("decode"):
                result = decode_with_fallback(
                    params, xa, prompt, cfg, tables, opts,
                    generator=generator, compute_dtype=compute_dtype,
                    tokenizer=tokenizer)
        else:
            lang_slot = (sot_pos + 1 if language is None
                         and cfg.multilingual else None)
            result = None
            for temp in _temperature_ladder(opts):
                result = batcher.submit(
                    window, prompt, temperature=temp,
                    lang_slot=lang_slot).result(timeout=_submit_timeout())
                if lang_slot is not None and result.language:
                    language = result.language
                    prompt[lang_slot] = tokenizer.language_token(language)
                    lang_slot = None
                if not needs_fallback(result.avg_logprob,
                                      token_entropy(result.tokens),
                                      len(result.tokens), opts,
                                      text=tokenizer.decode(result.tokens),
                                      no_speech_prob=result.no_speech_prob):
                    break

        time_offset = seek * HOP_LENGTH / SAMPLE_RATE
        if is_no_speech(result.no_speech_prob, result.avg_logprob, opts):
            seek += segment_size  # silence: skip the whole window
            continue

        raw_segments, advance = _split_segments(
            result.tokens, tb, segment_size, time_offset)

        window_words = None
        if opts.word_timestamps and result.tokens:
            from ..decode.timing import (find_word_timings,
                                         merge_punctuations,
                                         refine_word_durations)
            sot_seq = tokenizer.sot_sequence(
                language=lang if cfg.multilingual else None,
                task=opts.task, timestamps=opts.timestamps)
            window_words = find_word_timings(
                params, cfg, tokenizer, xa, result.tokens, sot_seq,
                num_frames=segment_size, time_offset=time_offset,
                alignment_heads=alignment_heads)
            merge_punctuations(window_words)
            refine_word_durations(window_words)

        # words go to segments by TOKEN ordinal, never by time: a running
        # clean-token cursor assigns each word to the segment its first
        # token falls in
        word_starts = None
        if window_words is not None:
            word_starts, c = [], 0
            for w in window_words:
                word_starts.append(c)
                c += len(w.tokens)

        n_before = len(segments)
        seg_tok_cursor = 0
        for rs in raw_segments:
            text = tokenizer.decode(rs["tokens"]).strip()
            seg_lo = seg_tok_cursor
            seg_tok_cursor += sum(1 for t in rs["tokens"] if t < cfg.eot)
            if not text:
                continue
            words = None
            if window_words is not None:
                words = [w for w, s in zip(window_words, word_starts)
                         if seg_lo <= s < seg_tok_cursor]
            segments.append(Segment(
                id=len(segments), seek=seek,
                start=rs["start"], end=rs["end"], text=text,
                tokens=rs["tokens"], temperature=result.temperature,
                avg_logprob=result.avg_logprob,
                no_speech_prob=result.no_speech_prob, words=words))

        if window_words is not None:
            # snap this window's segment bounds to their word anchors
            from ..decode.timing import refine_segments_with_words
            refine_segments_with_words(
                segments[n_before:], window_words,
                window_end=time_offset
                + segment_size * HOP_LENGTH / SAMPLE_RATE)

        # rolling context: text tokens only
        all_tokens.extend(t for t in result.tokens if t < cfg.eot)
        if result.temperature > 0.5:
            prompt_reset_since = len(all_tokens)
        seek += max(advance, 1)

    text = "".join(s.text if s.text.startswith(" ") else " " + s.text
                   for s in segments).strip()
    return TranscribeResult(text=text, segments=segments,
                            language=language or "en")
