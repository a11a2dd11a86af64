"""Whisper's decoding rules and the judgement of served tokens.

The rules are openai/whisper's ``SuppressBlank``, ``SuppressTokens`` (the
special tokens and, as whisper.cpp does, the language tokens) and
``ApplyTimestampRules`` with ``max_initial_timestamp`` 1.0 s, written out
from their published description; which ids a step allows depends only
on the tokens before it, except for the last rule, which forces a
timestamp when the timestamps' summed probability passes the best text
token's.

A served token is judged by its *gap* under the reference's logits L at
its step: the choice falls in two parts, the class (timestamp or text,
decided by logsumexp of the allowed timestamps against the largest
allowed text logit) and the token within the class (the largest allowed
logit of the class). The gap is how far the served token's class trails
the other class, if it does, plus how far the token's logit trails the
best of its class; a token the rules forbid has an infinite gap. A greedy
decoder that computes L exactly has gap 0 everywhere.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .tokens import Layout

MAX_INITIAL_TIMESTAMP_S = 1.0
SPACE_TOKEN = 32    # " " in the byte-level vocabulary


def allowed(history: Sequence[int], lay: Layout) -> np.ndarray:
    """(V,) bool: the ids the history-only rules allow at the next step."""
    v, tb = lay.n_vocab, lay.timestamp_begin
    ok = np.ones(v, bool)
    ok[[lay.sot, lay.sot_prev, lay.sot_lm, lay.translate, lay.transcribe,
        lay.no_speech, lay.no_timestamps]] = False
    ok[lay.lang_base: lay.lang_base + lay.n_langs] = False
    n = len(history)
    if n == 0:
        ok[[SPACE_TOKEN, lay.eot]] = False
        ok[:tb] = False
        ok[tb + int(round(MAX_INITIAL_TIMESTAMP_S / 0.02)) + 1:] = False
        return ok
    last_ts = history[-1] >= tb
    penult_ts = n < 2 or history[-2] >= tb
    if last_ts and penult_ts:
        ok[tb:] = False
    elif last_ts:
        ok[:lay.eot] = False
    ts = [t for t in history if t >= tb]
    if ts:
        floor = ts[-1] if (last_ts and not penult_ts) else ts[-1] + 1
        ok[tb:floor] = False
    return ok


def _parts(logits: np.ndarray, ok: np.ndarray, tb: int):
    ts = np.where(ok[tb:], logits[tb:], -np.inf)
    text = np.where(ok[:tb], logits[:tb], -np.inf)
    top = ts.max()
    lse = top + np.log(np.exp(ts - top).sum()) if np.isfinite(top) \
        else -np.inf
    return ts, text, lse


def gap(logits: np.ndarray, ok: np.ndarray, tok: int, tb: int) -> float:
    """The served token ``tok``'s gap under ``logits`` (float64)."""
    if not ok[tok]:
        return float("inf")
    ts, text, lse = _parts(logits, ok, tb)
    if tok >= tb:
        return max(0.0, text.max() - lse) + (ts.max() - logits[tok])
    return max(0.0, lse - text.max()) + (text.max() - logits[tok])


def choose(logits: np.ndarray, ok: np.ndarray, tb: int) -> int:
    """The greedy decoder's token under ``logits``."""
    ts, text, lse = _parts(logits, ok, tb)
    if lse > text.max():
        return tb + int(np.argmax(ts))
    return int(np.argmax(text))


def row_gaps(logits: np.ndarray, served: Sequence[int], lay: Layout,
             choices: np.ndarray = None) -> List[float]:
    """The gap at each served step; ``logits`` (N, V) are the reference's
    at the steps that produced ``served`` (N,). With ``choices`` (N, V
    logits of another model, the control) the tokens judged are the ones
    those logits choose, each after the served history."""
    out = []
    for j, tok in enumerate(served):
        ok = allowed(list(served[:j]), lay)
        lg = logits[j].astype(np.float64)
        if choices is not None:
            tok = choose(choices[j].astype(np.float64), ok,
                         lay.timestamp_begin)
        out.append(gap(lg, ok, int(tok), lay.timestamp_begin))
    return out
