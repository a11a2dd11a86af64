"""Word error rate and transcript normalization.

Evaluation tooling for the north-star check (transcripts matching
whisper.cpp greedy on LibriSpeech test-clean): Levenshtein WER over
normalized words, plus exact-match accounting. The normalizer covers the
standard ASR-eval basics (case, punctuation, whitespace, common English
contractions); it is intentionally simpler than openai's full English
normalizer and documented as such.
"""

from __future__ import annotations

import dataclasses
import re
import unicodedata
from typing import Iterable, List, Sequence, Tuple

_CONTRACTIONS = {
    "won't": "will not", "can't": "cannot", "n't": " not",
    "'re": " are", "'ve": " have", "'ll": " will", "'m": " am",
    "'d": " would",
}


def normalize_text(text: str) -> str:
    """Lowercase, strip punctuation/diacritics, expand basic contractions,
    collapse whitespace."""
    text = text.lower()
    # typographic apostrophes (HF/Whisper output uses U+2019) must fold
    # to ASCII BEFORE contraction expansion, or "don’t" misses the
    # table, loses its apostrophe to the punctuation strip, and scores
    # two errors against a verbatim-correct hypothesis
    text = text.replace("’", "'").replace("‘", "'")
    for k, v in _CONTRACTIONS.items():
        text = text.replace(k, v)
    text = unicodedata.normalize("NFKD", text)
    text = "".join(c for c in text if not unicodedata.combining(c))
    text = re.sub(r"[^a-z0-9' ]+", " ", text)
    text = text.replace("'", "")
    return re.sub(r"\s+", " ", text).strip()


def _levenshtein(ref: Sequence[str], hyp: Sequence[str]) -> Tuple[int, int,
                                                                  int]:
    """(substitutions, deletions, insertions) via DP."""
    n, m = len(ref), len(hyp)
    # cost, backtrace over (n+1) x (m+1)
    dp = [[0] * (m + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        dp[i][0] = i
    for j in range(m + 1):
        dp[0][j] = j
    for i in range(1, n + 1):
        ri = ref[i - 1]
        row = dp[i]
        prev = dp[i - 1]
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ri != hyp[j - 1])
            row[j] = min(sub, prev[j] + 1, row[j - 1] + 1)
    # backtrack for S/D/I split
    i, j = n, m
    s = d = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i][j] == dp[i - 1][j - 1] + \
                (ref[i - 1] != hyp[j - 1]):
            if ref[i - 1] != hyp[j - 1]:
                s += 1
            i -= 1
            j -= 1
        elif i > 0 and dp[i][j] == dp[i - 1][j] + 1:
            d += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return s, d, ins


@dataclasses.dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    ref_words: int
    exact_match: bool


def word_error_rate(reference: str, hypothesis: str,
                    normalize: bool = True) -> WerResult:
    ref_t = normalize_text(reference) if normalize else reference
    hyp_t = normalize_text(hypothesis) if normalize else hypothesis
    ref = ref_t.split()
    hyp = hyp_t.split()
    if not ref:
        wer = 0.0 if not hyp else float(len(hyp))
        return WerResult(wer, 0, 0, len(hyp), 0, ref == hyp)
    s, d, i = _levenshtein(ref, hyp)
    return WerResult((s + d + i) / len(ref), s, d, i, len(ref), ref == hyp)


def corpus_wer(pairs: Iterable[Tuple[str, str]]) -> WerResult:
    """Aggregate WER over (reference, hypothesis) pairs."""
    S = D = I = N = 0
    exact = True
    for ref, hyp in pairs:
        r = word_error_rate(ref, hyp)
        S += r.substitutions
        D += r.deletions
        I += r.insertions
        N += r.ref_words
        exact = exact and r.exact_match
    return WerResult((S + D + I) / max(N, 1), S, D, I, N, exact)
