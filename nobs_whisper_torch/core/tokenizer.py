"""Whisper byte-level BPE tokenizer.

The reference gets its tokenizer for free from whisper.cpp (the GGML file
embeds the byte-level vocab; whisper.cpp tokenizes prompts and detokenizes
segments internally — surfaced at src-tauri/src/whisper.rs:98-141). Here the
tokenizer is a standalone component: mergeable ranks come straight from the
checkpoint's embedded vocab (token id order == BPE merge rank order), and
the special-token table (languages, task, timestamps) is derived from the
model config.

Encoding is pure Python and needs neither ``tiktoken`` nor ``regex``: a
hand-written scanner splits the text as tiktoken's ``_PAT`` does (the
GPT-2 pre-tokenizer), classing characters with ``unicodedata``, and each
piece is merged by rank as tiktoken's ``byte_pair_merge`` merges it.
"""

from __future__ import annotations

import functools
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .config import WhisperConfig

# GPT-2 pre-tokenization pattern as used by openai-whisper's tiktoken setup.
# ``pretokenize`` below is a scanner for it; the string is kept as its
# specification.
_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"""
    r""" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)

# ``\s`` of the Rust regex crate: the Unicode White_Space property.
# (``str.isspace`` also takes U+001C-U+001F, which are not White_Space.)
_WHITE_SPACE = frozenset(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
     *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000])

# Letters (L) and numbers (N) of Unicode 15.1 and 16.0, the tables of
# tiktoken's regex crate, that Python 3.12's ``unicodedata`` (Unicode 15.0)
# calls unassigned: (first, last, class). Listed so that the scanner
# classes every code point as tiktoken does on any Python from 3.12 on.
_NEWER_CLASSES = (
    (0x1C89, 0x1C8A, "L"), (0xA7CB, 0xA7CD, "L"), (0xA7DA, 0xA7DC, "L"),
    (0x105C0, 0x105F3, "L"), (0x10D40, 0x10D49, "N"),
    (0x10D4A, 0x10D65, "L"), (0x10D6F, 0x10D85, "L"),
    (0x10EC2, 0x10EC4, "L"), (0x11380, 0x11389, "L"),
    (0x1138B, 0x1138B, "L"), (0x1138E, 0x1138E, "L"),
    (0x11390, 0x113B5, "L"), (0x113B7, 0x113B7, "L"),
    (0x113D1, 0x113D1, "L"), (0x113D3, 0x113D3, "L"),
    (0x116D0, 0x116E3, "N"), (0x11BC0, 0x11BE0, "L"),
    (0x11BF0, 0x11BF9, "N"), (0x13460, 0x143FA, "L"),
    (0x16100, 0x1611D, "L"), (0x16130, 0x16139, "N"),
    (0x16D40, 0x16D6C, "L"), (0x16D70, 0x16D79, "N"),
    (0x18CFF, 0x18CFF, "L"), (0x1CCF0, 0x1CCF9, "N"),
    (0x1E5D0, 0x1E5ED, "L"), (0x1E5F0, 0x1E5F0, "L"),
    (0x1E5F1, 0x1E5FA, "N"), (0x2EBF0, 0x2EE5D, "L"),
)

_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


@functools.lru_cache(maxsize=1 << 16)
def char_class(c: str) -> str:
    """The class ``_PAT`` sees: "S" white space, "L" letter, "N" number,
    "O" anything else (punctuation, symbols, marks, emoji, unassigned)."""
    cp = ord(c)
    if cp in _WHITE_SPACE:
        return "S"
    cat = unicodedata.category(c)[0]
    if cat in "LN":
        return cat
    if cp >= 0x1C89:
        for lo, hi, k in _NEWER_CLASSES:
            if lo <= cp <= hi:
                return k
    return "O"


def pretokenize(text: str) -> List[str]:
    """Split ``text`` as tiktoken splits it with ``_PAT``: at each position
    the first alternative that matches, each run greedy.

    - ``'s|'t|'re|'ve|'m|'ll|'d``: case-sensitive, ASCII apostrophe only;
    - `` ?\\p{L}+``, `` ?\\p{N}+``, `` ?[^\\s\\p{L}\\p{N}]+``: one run
      of a class, with at most one leading U+0020;
    - ``\\s+(?!\\S)``: a white-space run that ends the text, or the run
      less its last character when more follows (the regex backtracks by
      one, so "a   b" gives "a", "  ", " b"); else ``\\s+``, one
      character."""
    cls = [char_class(c) for c in text]
    n, i, out = len(text), 0, []
    while i < n:
        if text[i] == "'":
            suf = next((s for s in _CONTRACTIONS
                        if text.startswith(s, i + 1)), None)
            if suf is not None:
                out.append(text[i:i + 1 + len(suf)])
                i += 1 + len(suf)
                continue
        j = i + 1 if (text[i] == " " and i + 1 < n
                      and cls[i + 1] != "S") else i
        k, e = cls[j], j + 1
        if k != "S":
            while e < n and cls[e] == k:
                e += 1
        else:
            while e < n and cls[e] == "S":
                e += 1
            if e < n and e - i > 1:
                e -= 1
        out.append(text[i:e])
        i = e
    return out


_NO_RANK = 1 << 62

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
        self._pieces: Dict[bytes, Tuple[int, ...]] = {}   # BPE cache

    # ------------------------------------------------------------------
    # core encode / decode
    # ------------------------------------------------------------------
    def _bpe(self, piece: bytes) -> Tuple[int, ...]:
        """One pre-token's ids: the piece itself when it is in the ranks;
        else, from single bytes, merge the adjacent pair whose
        concatenation has the lowest rank (the leftmost on a tie) until no
        pair is in the ranks — tiktoken's ``byte_pair_merge``."""
        got = self._pieces.get(piece)
        if got is not None:
            return got
        ranks = self._ranks
        whole = ranks.get(piece)
        if whole is not None:
            got = (whole,)
        else:
            starts = list(range(len(piece) + 1))   # part j: starts[j]:[j+1]
            pair = [ranks.get(piece[a:a + 2], _NO_RANK)
                    for a in range(len(piece) - 1)]
            while pair:
                best = min(pair)
                if best == _NO_RANK:
                    break
                j = pair.index(best)
                del starts[j + 1]
                del pair[j]
                if j < len(pair):
                    pair[j] = ranks.get(piece[starts[j]:starts[j + 2]],
                                        _NO_RANK)
                if j > 0:
                    pair[j - 1] = ranks.get(
                        piece[starts[j - 1]:starts[j + 1]], _NO_RANK)
            got = tuple(ranks[piece[a:b]]
                        for a, b in zip(starts, starts[1:]))
        if len(self._pieces) >= 1 << 16:
            self._pieces.clear()
        self._pieces[piece] = got
        return got

    def encode(self, text: str) -> List[int]:
        """Text -> token ids (no special tokens), as tiktoken encodes it
        with ``_PAT`` over these ranks. Lone surrogates become U+FFFD, as
        in tiktoken's ``Encoding.encode``."""
        try:
            text.encode("utf-8")
        except UnicodeEncodeError:
            text = text.encode("utf-16", "surrogatepass").decode(
                "utf-16", "replace")
        ids: List[int] = []
        for piece in pretokenize(text):
            ids.extend(self._bpe(piece.encode("utf-8")))
        return ids

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
