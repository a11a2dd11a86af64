"""Post-hoc hallucination filter.

Behavioral port of the reference's phrase filter (capability, not code:
src-tauri/src/whisper.rs:199-260): transcripts that consist entirely of a
known YouTube-training-data hallucination phrase, or of punctuation/music
symbols only, are discarded. Applied per chunk after decoding, exactly as
the reference applies it after ``state.full``.
"""

from __future__ import annotations

import threading
import unicodedata

# Known hallucination phrases (EN/KO/JA/ZH + the bare "you"), matching the
# reference's table at src-tauri/src/whisper.rs:201-229.
HALLUCINATION_PHRASES = (
    "thank you for watching",
    "thanks for watching",
    "thank you for listening",
    "thanks for listening",
    "subscribe to my channel",
    "please subscribe",
    "like and subscribe",
    "see you in the next video",
    "see you next time",
    "please like and subscribe",
    "don't forget to subscribe",
    "hit the bell",
    "leave a comment",
    "check out my other videos",
    "thanks for tuning in",
    "시청해 주셔서 감사합니다",
    "구독과 좋아요",
    "구독 부탁드립니다",
    "ご視聴ありがとうございました",
    "感谢收看",
    "谢谢观看",
    "you",
    "MBC 뉴스 이덕영입니다",
)

_EXTRA_PUNCT = {"…", "♪", "♫", "♬"}


def _is_punctish(ch: str) -> bool:
    if ch in _EXTRA_PUNCT:
        return True
    return ch.isascii() and not ch.isalnum() and not ch.isspace() and \
        unicodedata.category(ch).startswith(("P", "S"))


# accept/reject accounting: the phrase table is a behavioral port whose
# real-speech hit-rate has never been priced (the box is zero-egress) —
# eval.py reports these counters so scripts/real_weight_gate.py's
# hallucination stage can measure the false-drop rate the moment real
# weights + real speech exist
_stats_lock = threading.Lock()
_stats = {"calls": 0, "dropped": 0, "dropped_texts": []}


def reset_filter_stats() -> None:
    with _stats_lock:
        _stats.update(calls=0, dropped=0, dropped_texts=[])


def get_filter_stats() -> dict:
    with _stats_lock:
        return {"calls": _stats["calls"], "dropped": _stats["dropped"],
                "dropped_texts": list(_stats["dropped_texts"])}


def _record(dropped: bool, text: str) -> None:
    with _stats_lock:
        _stats["calls"] += 1
        if dropped:
            _stats["dropped"] += 1
            if len(_stats["dropped_texts"]) < 50:
                _stats["dropped_texts"].append(text[:120])


def filter_hallucinations(text: str) -> str:
    """Return '' if the text is a known hallucination, else the trimmed text."""
    trimmed = text.strip()
    if not trimmed:
        _record(False, text)    # empty input is not a filter decision
        return ""

    # punctuation/music-symbol-only output (e.g. "...", "♪")
    if all(_is_punctish(c) for c in trimmed):
        _record(True, trimmed)
        return ""

    lower = trimmed.lower()
    stripped = lower.rstrip("".join(_EXTRA_PUNCT) +
                            r"""!"#$%&'()*+,-./:;<=>?@[\]^_`{|}~""")
    for phrase in HALLUCINATION_PHRASES:
        if stripped == phrase.lower():
            _record(True, trimmed)
            return ""
    _record(False, trimmed)
    return trimmed
