"""Logit-processing rules of the Whisper decode loop (port of
``decode/rules.py``): openai-whisper's SuppressBlank / SuppressTokens /
ApplyTimestampRules, vectorized over the batch, plus the host-side quality
gates of the temperature-fallback ladder."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import WhisperConfig
from ..core.device import scalar

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class DecodeOptions:
    """Sampling options (defaults = the reference's greedy configuration).

    The port serves greedy, temperature sampling, beam search
    (``beam_size`` > 1 at temperature 0) and exact speculative greedy
    (``speculative`` K drafted tokens a pass over ``draft_pool`` x pooled
    cross-KV; beam wins where both are set), with plain, packed bf16
    (``xattn_bf16``) or int8 (``q8_cross_kv``) cross-KV, and word
    timestamps (``decode/timing.py``)."""

    task: str = "transcribe"
    language: Optional[str] = None          # None = auto-detect
    temperature: float = 0.0
    best_of: int = 1
    beam_size: Optional[int] = None
    timestamps: bool = True
    suppress_blank: bool = True
    suppress_non_speech: bool = False
    max_initial_timestamp: float = 1.0
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    entropy_threshold: float = 2.4
    compression_ratio_threshold: float = 2.4
    temperature_increment: float = 0.2
    max_temperature: float = 1.0
    sample_len: Optional[int] = None        # default n_text_ctx // 2
    q8_cross_kv: bool = False
    xattn_bf16: bool = False
    word_timestamps: bool = False
    speculative: int = 0
    draft_pool: int = 4


@dataclasses.dataclass(frozen=True)
class RuleTables:
    """Precomputed static masks/ids for one (config, options) pair."""

    suppress_mask: torch.Tensor        # (V,) bool — always-suppressed ids
    blank_mask: torch.Tensor           # (V,) bool — first-step blank ids
    timestamp_begin: int
    eot: int
    no_timestamps: int
    n_vocab: int
    timestamps_enabled: bool
    max_initial_ts_tok: int

    def to(self, device) -> "RuleTables":
        return dataclasses.replace(
            self, suppress_mask=self.suppress_mask.to(device),
            blank_mask=self.blank_mask.to(device))


def build_rule_tables(cfg: WhisperConfig, opts: DecodeOptions,
                      tokenizer=None, device="cpu") -> RuleTables:
    """Assemble the static suppression tables. ``tokenizer`` supplies the
    blank token and non-speech ids; when absent those rules degrade."""
    v = cfg.n_vocab
    suppress = np.zeros(v, bool)
    for t in (cfg.sot, cfg.sot_prev, cfg.sot_lm, cfg.translate,
              cfg.transcribe, cfg.no_speech):
        if t < v:
            suppress[t] = True
    suppress[cfg.lang_base: cfg.lang_base + cfg.n_langs] = True
    if opts.suppress_non_speech and tokenizer is not None:
        for t in tokenizer.non_speech_tokens:
            suppress[t] = True

    blank = np.zeros(v, bool)
    if opts.suppress_blank:
        if tokenizer is not None:
            sp = tokenizer.encode(" ")
            if sp:
                blank[sp[0]] = True
        blank[cfg.eot] = True

    max_init_idx = int(round(opts.max_initial_timestamp / 0.02))
    return RuleTables(
        suppress_mask=torch.as_tensor(suppress, device=device),
        blank_mask=torch.as_tensor(blank, device=device),
        timestamp_begin=cfg.timestamp_begin,
        eot=cfg.eot,
        no_timestamps=cfg.no_timestamps,
        n_vocab=v,
        timestamps_enabled=opts.timestamps,
        max_initial_ts_tok=cfg.timestamp_begin + max_init_idx,
    )


def apply_logit_rules(logits: torch.Tensor, tables: RuleTables, *,
                      n_sampled, last_token, penult_token, max_ts_token
                      ) -> torch.Tensor:
    """All per-step suppression rules -> masked logits (B, V)."""
    return apply_logit_rules_scored(
        logits, tables, n_sampled=n_sampled, last_token=last_token,
        penult_token=penult_token, max_ts_token=max_ts_token)[0]


def _lse(x: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(x, dim=-1)


def apply_logit_rules_scored(
    logits: torch.Tensor,        # (B, V) f32
    tables: RuleTables,
    *,
    n_sampled: torch.Tensor,     # (B,) int — tokens sampled so far
    last_token: torch.Tensor,    # (B,) int
    penult_token: torch.Tensor,  # (B,) int
    max_ts_token: torch.Tensor,  # (B,) int — highest ts sampled; tb-1 if none
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """apply_logit_rules + scoring byproducts: (masked (B, V),
    lse = logsumexp(masked) (B,), greedy_logit = max(masked) (B,))."""
    b, v = logits.shape
    tb = tables.timestamp_begin
    ids = torch.arange(v, device=logits.device)[None, :]
    is_first = (n_sampled == 0)[:, None]
    static_mask = tables.suppress_mask[None, :]
    neg = scalar(NEG_INF, logits.dtype, logits.device)

    if not tables.timestamps_enabled:
        mask = (static_mask | (is_first & tables.blank_mask[None, :])
                | (ids >= tb) | (ids == tables.no_timestamps))
        masked = torch.where(mask, neg, logits)
        text = torch.where(ids >= tb, neg, masked)
        return masked, _lse(text), torch.amax(text, dim=-1)

    ts_region = ids >= tb
    last_is_ts = ((n_sampled >= 1) & (last_token >= tb))[:, None]
    penult_is_ts = ((n_sampled < 2) | (penult_token >= tb))[:, None]
    pair_ts = last_is_ts & penult_is_ts
    pair_text = last_is_ts & ~penult_is_ts

    has_ts = (max_ts_token >= tb)[:, None]
    floor = torch.where(pair_text, max_ts_token[:, None],
                        max_ts_token[:, None] + 1)

    mask = (static_mask
            | (ids == tables.no_timestamps)
            | (is_first & tables.blank_mask[None, :])
            | (pair_ts & ts_region)
            | (pair_text & (ids < tables.eot))
            | (has_ts & ts_region & (ids < floor))
            | (is_first & (~ts_region | (ids > tables.max_initial_ts_tok))))
    masked = torch.where(mask, neg, logits)

    ts_part = torch.where(ts_region, masked, neg)
    text_part = torch.where(ts_region, neg, masked)
    ts_lse = _lse(ts_part)
    nonts_lse = _lse(text_part)
    ts_max = torch.amax(ts_part, dim=-1)
    max_text = torch.amax(text_part, dim=-1)
    force_ts = ts_lse > max_text
    masked = torch.where(force_ts[:, None] & ~ts_region, neg, masked)

    lse = torch.where(force_ts, ts_lse, torch.logaddexp(ts_lse, nonts_lse))
    greedy_logit = torch.where(force_ts, ts_max,
                               torch.maximum(ts_max, max_text))
    return masked, lse, greedy_logit


# ---------------------------------------------------------------------------
# segment scoring (host-side; feeds the temperature-fallback ladder)
# ---------------------------------------------------------------------------

def token_entropy(tokens: Sequence[int], window: int = 32) -> float:
    """Shannon entropy of the last ``window`` sampled token counts."""
    tail = list(tokens)[-window:]
    if not tail:
        return 0.0
    _, counts = np.unique(tail, return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log(p)).sum())


def compression_ratio(text: str) -> float:
    """openai-whisper's zlib repetition score."""
    import zlib
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def needs_fallback(avg_logprob: float, entropy: float, n_tokens: int,
                   opts: DecodeOptions, *, text: Optional[str] = None,
                   no_speech_prob: Optional[float] = None) -> bool:
    """Retry the window at a higher temperature? The silence override
    wins over every quality gate."""
    if (no_speech_prob is not None
            and no_speech_prob > opts.no_speech_threshold):
        return False
    if avg_logprob < opts.logprob_threshold:
        return True
    if n_tokens >= 32 and entropy < opts.entropy_threshold:
        return True
    if (text is not None and opts.compression_ratio_threshold is not None
            and compression_ratio(text) > opts.compression_ratio_threshold):
        return True
    return False


def is_no_speech(no_speech_prob: float, avg_logprob: float,
                 opts: DecodeOptions) -> bool:
    """Silence gate: both conditions required."""
    return (no_speech_prob > opts.no_speech_threshold
            and avg_logprob < opts.logprob_threshold)
