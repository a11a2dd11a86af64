"""Whisper byte-level BPE tokenizer.

The reference gets its tokenizer for free from whisper.cpp (the GGML file
embeds the byte-level vocab; whisper.cpp tokenizes prompts and detokenizes
segments internally — surfaced at src-tauri/src/whisper.rs:98-141). Here the
tokenizer is a standalone component: mergeable ranks come straight from the
checkpoint's embedded vocab (token id order == BPE merge rank order), exact
BPE encoding runs on tiktoken's rank-merge core, and the special-token table
(languages, task, timestamps) is derived from the model config.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .config import WhisperConfig

# GPT-2 pre-tokenization pattern as used by openai-whisper's tiktoken setup.
_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

# Whisper language registry in token-id order: <|en|> is lang_base, etc.
# The first 99 cover all pre-v3 vocabs; large-v3-era vocabs append "yue".
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


class WhisperTokenizer:
    """Exact byte-level BPE over a checkpoint-embedded vocab."""

    def __init__(self, vocab: Sequence[bytes], config: WhisperConfig):
        self.config = config
        self.n_vocab = config.n_vocab
        self.eot = config.eot
        self.sot = config.sot
        self.translate = config.translate
        self.transcribe = config.transcribe
        self.sot_lm = config.sot_lm
        self.sot_prev = config.sot_prev
        self.no_speech = config.no_speech
        self.no_timestamps = config.no_timestamps
        self.timestamp_begin = config.timestamp_begin
        self.lang_base = config.lang_base
        self.n_langs = config.n_langs

        # id -> raw bytes for every non-special token; specials rendered
        # symbolically.
        self._vocab: List[bytes] = list(vocab)
        if len(self._vocab) < self.n_vocab:
            self._vocab += [
                f"[_extra_token_{i}]".encode()
                for i in range(len(self._vocab), self.n_vocab)
            ]

        ranks: Dict[bytes, int] = {}
        for i in range(min(self.eot, len(self._vocab))):
            tok = self._vocab[i]
            if tok not in ranks:  # first occurrence wins the merge rank
                ranks[tok] = i
        self._ranks = ranks
        self._enc = None   # built on the first encode()

    # ------------------------------------------------------------------
    # core encode / decode
    # ------------------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        """Text -> token ids (no special tokens).

        ``tiktoken`` is imported here, not in ``__init__``: decoding needs
        only the vocab bytes, so a machine without ``tiktoken`` can still
        serve requests that carry no text prompt. A single character is
        always one pre-token, and BPE maps a pre-token that is itself a
        vocab entry to that entry, so that case (the blank-suppression
        lookup of " ") is answered from the ranks directly."""
        if len(text) == 1 and text.encode("utf-8") in self._ranks:
            return [self._ranks[text.encode("utf-8")]]
        if self._enc is None:
            import tiktoken  # offline: ranks are supplied

            self._enc = tiktoken.Encoding(
                name=f"whisper-{self.config.name}",
                pat_str=_PAT,
                mergeable_ranks=self._ranks,
                special_tokens={},  # specials handled explicitly below
            )
        return self._enc.encode(text, disallowed_special=())

    def decode(self, ids: Iterable[int]) -> str:
        """Token ids -> text, dropping all special/timestamp tokens."""
        parts = []
        for i in ids:
            if i < self.eot:
                parts.append(self._vocab[i])
        return b"".join(parts).decode("utf-8", errors="replace")

    def decode_with_timestamps(self, ids: Iterable[int]) -> str:
        parts: List[str] = []
        buf: List[bytes] = []

        def flush():
            if buf:
                parts.append(b"".join(buf).decode("utf-8", errors="replace"))
                buf.clear()

        for i in ids:
            if i < self.eot:
                buf.append(self._vocab[i])
            elif i >= self.timestamp_begin:
                flush()
                parts.append(f"<|{self.timestamp_to_seconds(i):.2f}|>")
            else:
                flush()
                parts.append(self.id_to_text(i))
        flush()
        return "".join(parts)

    def id_to_text(self, i: int) -> str:
        """Render any single token id (specials symbolically)."""
        if i < self.eot:
            return self._vocab[i].decode("utf-8", errors="replace")
        if i == self.eot:
            return "<|endoftext|>"
        if i == self.sot:
            return "<|startoftranscript|>"
        if self.lang_base <= i < self.lang_base + self.n_langs:
            return f"<|{LANGUAGES[i - self.lang_base]}|>"
        if i == self.translate:
            return "<|translate|>"
        if i == self.transcribe:
            return "<|transcribe|>"
        if i == self.sot_lm:
            return "<|startoflm|>"
        if i == self.sot_prev:
            return "<|startofprev|>"
        if i == self.no_speech:
            return "<|nospeech|>"
        if i == self.no_timestamps:
            return "<|notimestamps|>"
        if i >= self.timestamp_begin:
            return f"<|{self.timestamp_to_seconds(i):.2f}|>"
        return f"[_unknown_{i}]"

    # ------------------------------------------------------------------
    # special-token helpers
    # ------------------------------------------------------------------
    def language_token(self, lang: str) -> int:
        lang = lang.lower()
        if lang not in LANGUAGES[: self.n_langs]:
            raise KeyError(f"unknown language {lang!r}")
        return self.lang_base + LANGUAGES.index(lang)

    def token_language(self, token: int) -> str:
        idx = token - self.lang_base
        if not 0 <= idx < self.n_langs:
            raise KeyError(f"token {token} is not a language token")
        return LANGUAGES[idx]

    def timestamp_to_seconds(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    def seconds_to_timestamp(self, seconds: float) -> int:
        return self.timestamp_begin + int(round(seconds / 0.02))

    def sot_sequence(
        self,
        language: Optional[str] = None,
        task: str = "transcribe",
        timestamps: bool = True,
    ) -> List[int]:
        """[sot, lang, task(, notimestamps)] — the decoder's forced prefix."""
        if task not in ("transcribe", "translate"):
            raise ValueError(
                f"unknown task {task!r}; have transcribe, translate")
        seq = [self.sot]
        if self.config.multilingual:
            seq.append(self.language_token(language or "en"))
            seq.append(self.transcribe if task == "transcribe"
                       else self.translate)
        if not timestamps:
            seq.append(self.no_timestamps)
        return seq

    def is_timestamp(self, token: int) -> bool:
        return token >= self.timestamp_begin

    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids suppressed by the "-1" suppress list.

        Mirrors openai-whisper's ``Tokenizer.non_speech_tokens`` (which
        whisper.cpp reproduces): bracket/quote/music symbols that only ever
        appear in hallucinated captions.
        """
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = set()
        for seed in (" -", " '"):
            toks = self.encode(seed)
            if toks:
                result.add(toks[0])
        for symbol in symbols + list(miscellaneous):
            for tokens in (self.encode(symbol), self.encode(" " + symbol)):
                if len(tokens) == 1 or symbol in miscellaneous:
                    if tokens:
                        result.add(tokens[0])
        return tuple(sorted(result))


def build_tokenizer(vocab: Sequence[bytes],
                    config: WhisperConfig) -> WhisperTokenizer:
    return WhisperTokenizer(vocab, config)
