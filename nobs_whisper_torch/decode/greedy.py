"""Batched window decode: greedy and temperature sampling (port of
``decode/greedy.py``).

The reference runs prefill, the per-step logits, rules, sampling and stop
handling as one jitted device program with a ``lax.while_loop``. PyTorch
runs eagerly, so here the step loop is a Python loop over device tensors
that exits early once every row is done (checked every ``_EXIT_CHECK``
steps, one host sync each; rows that are done keep emitting eot and do not
change the result). Ragged batches are left-padded; sampling draws from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..models.whisper import (decoder_forward, init_kv_cache,
                              precompute_cross_kv, precompute_cross_kv_q8,
                              xattn_kernel_enabled)
from ..ops.attention_pallas import pack_cross_kv_bf16, quantize_cross_kv
from .rules import DecodeOptions, RuleTables, apply_logit_rules_scored

_EXIT_CHECK = 8


def kt_xattn_default(compute_dtype) -> bool:
    """Packed (Dh, T) cross-K layout, read at each call as the reference
    reads it (decode/greedy.py:29-46), with the card in the TPU's place:
    ``NWT_NO_KT_XATTN`` opts out, ``NWT_FORCE_KT`` forces it at any
    compute dtype, otherwise on at bf16 (the serving path) and off at f32."""
    if os.environ.get("NWT_NO_KT_XATTN"):
        return False
    if os.environ.get("NWT_FORCE_KT"):
        return True
    return compute_dtype == torch.bfloat16


@dataclasses.dataclass
class WindowResult:
    """Per-batch-element outcome of one 30 s window decode."""

    tokens: List[int]            # sampled tokens, eot stripped
    sum_logprob: float           # includes the stop token's logprob
    avg_logprob: float           # sum / (n_text_tokens + 1)
    no_speech_prob: float
    temperature: float
    language: Optional[str] = None   # set when the batcher auto-detected


def _pad_len(n: int) -> int:
    """Quantize prompt pad length (the reference's recompile bound; kept
    so prompts pad identically)."""
    for p in (8, 32, 64, 128, 256):
        if n <= p:
            return p
    return 256


def pad_prompts(prompts: Sequence[Sequence[int]],
                eot: int) -> Tuple[np.ndarray, np.ndarray]:
    """LEFT-pad ragged prompts with eot -> (tokens (B, P_max), pad_lens)."""
    lens = np.array([len(p) for p in prompts], np.int32)
    p_max = _pad_len(int(lens.max()))
    out = np.full((len(prompts), p_max), eot, np.int32)
    for i, p in enumerate(prompts):
        out[i, p_max - len(p):] = p
    return out, (p_max - lens).astype(np.int32)


def _sample(masked: torch.Tensor, temperature: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
    """Per-row categorical draw from softmax(masked / t) (Gumbel-max)."""
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    u = torch.rand(masked.shape, generator=generator,
                   device=masked.device).clamp_(min=1e-20, max=1.0 - 1e-7)
    return torch.argmax(masked / temp - torch.log(-torch.log(u)), dim=-1)


def window_cross_kv(params, xa: torch.Tensor, cfg: WhisperConfig,
                    q8_kv: bool, xattn_bf16: bool, raw=None):
    """The decode loop's cross-KV: int8 with ``q8_kv`` (projected and
    quantized one layer at a time unless ``raw``, the projected K/V, is
    given), else packed bf16 with ``xattn_bf16``, else plain."""
    if q8_kv:
        if raw is not None:
            return quantize_cross_kv(raw)
        return precompute_cross_kv_q8(params, xa, cfg)
    if raw is None:
        raw = precompute_cross_kv(params, xa, cfg)
    if not xattn_bf16:
        return raw
    kT, v = pack_cross_kv_bf16(raw)
    if not xattn_kernel_enabled():
        # without K4 (which reads bf16) the scores/PV run on f32 copies of
        # the bf16 values, made once per window instead of once per step
        return {"kT": kT["kT"].float()}, {"v": v["v"].float()}
    return kT, v


@torch.inference_mode()
def decode_window_impl(params, xa: torch.Tensor, prompt_tokens: torch.Tensor,
                       pad_lens: torch.Tensor, sot_idx: torch.Tensor,
                       tables: RuleTables, temperature: torch.Tensor,
                       generator: Optional[torch.Generator],
                       cfg: WhisperConfig, sample_len: int,
                       compute_dtype=torch.float32, q8_kv: bool = False,
                       xattn_bf16: bool = False, sampling: bool = True):
    """Returns (tokens (B, sample_len), n_sampled (B,), sum_logprob (B,),
    no_speech_prob (B,)), all device tensors; the cross-KV layout is
    :func:`window_cross_kv`'s."""
    b, p_max = prompt_tokens.shape
    dev = xa.device
    cross_kv = window_cross_kv(params, xa, cfg, q8_kv, xattn_bf16)
    t_cache = -(-(p_max + sample_len) // 8) * 8
    cache = init_kv_cache(cfg, b, dtype=compute_dtype,
                          t_ctx=min(t_cache, cfg.n_text_ctx), device=dev)

    logits_all, cache = decoder_forward(
        params, prompt_tokens, 0, pad_lens, cache, cross_kv, cfg,
        compute_dtype)
    logits = logits_all[:, -1]
    sot_logits = logits_all[torch.arange(b, device=dev), sot_idx]
    no_speech_prob = torch.softmax(sot_logits, dim=-1)[:, cfg.no_speech]

    tb, eot = tables.timestamp_begin, tables.eot
    tokens = torch.full((b, sample_len), eot, dtype=torch.long, device=dev)
    sum_logprob = torch.zeros((b,), dtype=torch.float32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    max_ts = torch.full((b,), tb - 1, dtype=torch.long, device=dev)
    last = torch.zeros((b,), dtype=torch.long, device=dev)
    penult = torch.zeros((b,), dtype=torch.long, device=dev)
    eot_t = torch.tensor(eot, device=dev)

    for step in range(sample_len):
        if step and step % _EXIT_CHECK == 0 and bool(done.all()):
            break
        masked, lse, greedy_logit = apply_logit_rules_scored(
            logits.float(), tables,
            n_sampled=torch.full((b,), step, device=dev),
            last_token=last, penult_token=penult, max_ts_token=max_ts)
        greedy_tok = torch.argmax(masked, dim=-1)
        if sampling:
            sampled = _sample(masked, temperature, generator)
            tok = torch.where(temperature > 0, sampled, greedy_tok)
            tok_logit = torch.gather(masked, 1, tok[:, None])[:, 0]
        else:
            tok, tok_logit = greedy_tok, greedy_logit
        tok = torch.where(done, eot_t, tok)
        sum_logprob += torch.where(done, 0.0, tok_logit - lse)
        tokens[:, step] = tok
        max_ts = torch.where((tok >= tb) & ~done,
                             torch.maximum(max_ts, tok), max_ts)
        penult = torch.where(done, penult, last)
        last = torch.where(done, last, tok)
        done = done | (tok == eot)
        if step + 1 < sample_len:
            logits_next, cache = decoder_forward(
                params, tok[:, None], p_max + step, pad_lens, cache,
                cross_kv, cfg, compute_dtype)
            logits = logits_next[:, 0]
    n_sampled = torch.sum(tokens != eot, dim=1)
    return tokens, n_sampled, sum_logprob, no_speech_prob


def frames_encode_decode_window_impl(
    params, frames, prompt_tokens, pad_lens, sot_idx, tables, temperature,
    generator, cfg, sample_len, compute_dtype=torch.float32, q8_kv=False,
    xattn_bf16=False, sampling=True,
):
    """STFT-framed audio -> mel -> encoder -> decode loop: the serving
    main path (frames from ``audio/mel.py::frame_window_np``)."""
    from ..audio.mel import log_mel_from_frames
    from ..models.whisper import encode
    mel = log_mel_from_frames(frames, n_mels=cfg.n_mels,
                              n_frames=2 * cfg.n_audio_ctx)
    xa = encode(params, mel, cfg, compute_dtype=compute_dtype)
    return decode_window_impl(params, xa, prompt_tokens, pad_lens, sot_idx,
                              tables, temperature, generator, cfg,
                              sample_len, compute_dtype, q8_kv,
                              xattn_bf16, sampling)


def decode_window_dispatch(
    params,
    xa: Optional[torch.Tensor],
    prompts: Sequence[Sequence[int]],
    cfg: WhisperConfig,
    tables: RuleTables,
    opts: DecodeOptions,
    temperature=0.0,             # scalar or per-element sequence
    generator: Optional[torch.Generator] = None,
    compute_dtype=torch.float32,
    mel: Optional[torch.Tensor] = None,     # fuse encode
    frames: Optional[torch.Tensor] = None,  # fuse mel + encode
    speculative: int = 0,        # K > 0: exact speculative greedy
    draft_pool: int = 4,
    draft=None,                  # (draft_params, draft_cfg); None = self
):
    """Pad prompts and run the window decode; returns the handle that
    :func:`decode_window_finalize` scores. Exactly one of ``xa``, ``mel``
    and ``frames`` is given.

    With ``speculative`` K > 0 (or ``opts.speculative``; the explicit
    argument wins, as does an explicit ``draft_pool`` other than 4) and
    every row at temperature 0, the batch decodes by exact speculative
    greedy (``decode/speculative.py``) and the handle gains a sixth
    element, the pass count; rows above temperature 0 (ladder rungs) take
    the sampling loop."""
    n = len(prompts)
    speculative = speculative or opts.speculative
    if draft_pool == 4 and opts.draft_pool != 4:
        draft_pool = opts.draft_pool
    src = next(z for z in (frames, mel, xa) if z is not None)
    dev = src.device
    prompt_np, pad_np = pad_prompts(prompts, cfg.eot)
    p_max = prompt_np.shape[1]
    sot_np = np.array([pad_np[i] + list(p).index(cfg.sot)
                       for i, p in enumerate(prompts)], np.int64)
    sample_len = opts.sample_len or cfg.n_text_ctx // 2
    sample_len = min(sample_len, cfg.n_text_ctx - p_max)
    temps = np.broadcast_to(np.asarray(temperature, np.float32),
                            (n,)).copy()
    sampling = bool(np.any(temps > 0))
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    xattn_bf16 = (opts.xattn_bf16 or bool(os.environ.get("NWT_XATTN_BF16"))
                  or kt_xattn_default(compute_dtype))
    if speculative > 0 and not sampling:
        from . import speculative as sp
        d_params, d_cfg = draft if draft is not None else (params, cfg)
        common = (torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
                  torch.as_tensor(pad_np, dtype=torch.long, device=dev),
                  torch.as_tensor(sot_np, device=dev), tables.to(dev), cfg,
                  d_cfg, sample_len, speculative, draft_pool, compute_dtype,
                  xattn_bf16, opts.q8_cross_kv, draft is None)
        if frames is not None:
            out = sp.frames_encode_decode_speculative_impl(
                params, d_params, frames, *common)
        elif mel is not None:
            out = sp.encode_decode_speculative_impl(params, d_params, mel,
                                                    *common)
        else:
            out = sp.decode_window_speculative_impl(params, d_params, xa,
                                                    *common)
        tokens, n_sampled, sum_lp, nsp, passes = out
        return (tokens, n_sampled, sum_lp, nsp, temps, passes)
    args = (torch.as_tensor(prompt_np, dtype=torch.long, device=dev),
            torch.as_tensor(pad_np, dtype=torch.long, device=dev),
            torch.as_tensor(sot_np, device=dev), tables.to(dev),
            torch.as_tensor(temps, device=dev), generator, cfg, sample_len,
            compute_dtype, opts.q8_cross_kv, xattn_bf16, sampling)
    if frames is not None:
        out = frames_encode_decode_window_impl(params, frames, *args)
    else:
        if mel is not None:
            from ..models.whisper import encode
            xa = encode(params, mel, cfg, compute_dtype=compute_dtype)
        out = decode_window_impl(params, xa, *args)
    return (*out, temps)


def decode_window_finalize(handle) -> List[WindowResult]:
    """Copy the decode's device tensors to the host and score them."""
    tokens, n_sampled, sum_lp, nsp, temps = handle[:5]
    tokens = tokens.cpu().numpy()
    n_sampled = n_sampled.cpu().numpy()
    sum_lp = sum_lp.cpu().numpy()
    nsp = nsp.float().cpu().numpy()
    out = []
    for i in range(tokens.shape[0]):
        toks = tokens[i, : n_sampled[i]].tolist()
        out.append(WindowResult(
            tokens=toks,
            sum_logprob=float(sum_lp[i]),
            avg_logprob=float(sum_lp[i]) / (len(toks) + 1),
            no_speech_prob=float(nsp[i]),
            temperature=float(temps[i]),
        ))
    return out


def decode_window(params, xa, prompts, cfg, tables, opts, temperature=0.0,
                  generator=None, compute_dtype=torch.float32, mel=None
                  ) -> List[WindowResult]:
    """Host wrapper: pad prompts, run the decode loop, score results."""
    return decode_window_finalize(decode_window_dispatch(
        params, xa, prompts, cfg, tables, opts, temperature, generator,
        compute_dtype, mel))


# ---------------------------------------------------------------------------
# language detection
# ---------------------------------------------------------------------------

@torch.inference_mode()
def detect_language(params, xa: torch.Tensor, cfg: WhisperConfig,
                    compute_dtype=torch.float32):
    """Single forward from [sot]: softmax over the language tokens.
    Returns (lang_idx (B,), lang_probs (B, n_langs))."""
    b = xa.shape[0]
    dev = xa.device
    cross_kv = precompute_cross_kv(params, xa, cfg)
    cache = init_kv_cache(cfg, b, dtype=compute_dtype, t_ctx=8, device=dev)
    sot = torch.full((b, 1), cfg.sot, dtype=torch.long, device=dev)
    logits, _ = decoder_forward(params, sot, 0,
                                torch.zeros((b,), dtype=torch.long,
                                            device=dev),
                                cache, cross_kv, cfg, compute_dtype)
    logits = logits[:, 0]
    lo, hi = cfg.lang_base, cfg.lang_base + cfg.n_langs
    masked = torch.full_like(logits, -1e30)
    masked[:, lo:hi] = logits[:, lo:hi]
    lang_probs = torch.softmax(masked, dim=-1)[:, lo:hi]
    return torch.argmax(lang_probs, dim=-1), lang_probs


def frames_encode_impl(params, frames, cfg: WhisperConfig,
                       compute_dtype=torch.float32) -> torch.Tensor:
    """STFT frames -> mel -> encoder states, without language detection:
    the beam batcher's fixed-language batches need the encoder states but
    no detect forward."""
    from ..audio.mel import log_mel_from_frames
    from ..models.whisper import encode
    mel = log_mel_from_frames(frames, n_mels=cfg.n_mels,
                              n_frames=2 * cfg.n_audio_ctx)
    return encode(params, mel, cfg, compute_dtype=compute_dtype)


def frames_encode_detect_impl(params, frames, cfg: WhisperConfig,
                              compute_dtype=torch.float32):
    """STFT frames -> mel -> encoder states + detected languages. Returns
    (xa, lang_idx, lang_probs); xa feeds decode_window_dispatch."""
    xa = frames_encode_impl(params, frames, cfg, compute_dtype)
    lang_idx, lang_probs = detect_language(params, xa, cfg, compute_dtype)
    return xa, lang_idx, lang_probs
