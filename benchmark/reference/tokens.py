"""The benchmark's vocabulary, special-token layout and byte-pair encoder.

The program under test is served with this vocabulary (the benchmark hands
the same list to its tokenizer), and the reference tokenizes the prompts
again with the plain encoder below, so the reference takes no token id
that the program produced.

``byte_level_vocab`` builds a vocabulary as
``nobs_whisper_torch/utils/testing.py::byte_level_vocab`` does (the
synthetic vocabulary of ``WhisperEngine.from_random``, as of the port's
twenty-first slice), with a faster random generator: the ids differ from
that one's, the kind of vocabulary does not.
"""

from __future__ import annotations

import re
from typing import Dict, List, NamedTuple

import numpy as np


class Layout(NamedTuple):
    """openai-whisper's multilingual special-token ids for a vocabulary
    of ``n_vocab`` ids (51866: large-v3, 100 languages)."""

    n_vocab: int
    eot: int
    sot: int
    lang_base: int
    n_langs: int
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int


def layout(n_vocab: int) -> Layout:
    n_langs = 100 if n_vocab == 51866 else 99
    eot = 50257
    lang_base = eot + 2
    translate = lang_base + n_langs
    return Layout(n_vocab=n_vocab, eot=eot, sot=eot + 1, lang_base=lang_base,
                  n_langs=n_langs, translate=translate,
                  transcribe=translate + 1, sot_lm=translate + 2,
                  sot_prev=translate + 3, no_speech=translate + 4,
                  no_timestamps=translate + 5,
                  timestamp_begin=translate + 6)


def byte_level_vocab(lay: Layout, seed: int = 0) -> List[bytes]:
    """256 byte tokens, fixed English-ish merges, random merges of earlier
    tokens (at most 8 bytes) up to ``eot``, then placeholders for the
    special range: the construction of the port's synthetic vocabulary,
    with its random pairs drawn in bulk (a NumPy ``Generator``, 8192 pairs
    of the tokens so far at a time) so that a run makes it in a second."""
    rng = np.random.default_rng(seed)
    vocab: List[bytes] = [bytes([b]) for b in range(256)]
    seen = set(vocab)
    for merge in [b" t", b"he", b" a", b"in", b" th", b"er", b" the", b"ing",
                  b" s", b" w", b"ou", b" he", b" o", b"re", b" i"]:
        if merge not in seen:
            vocab.append(merge)
            seen.add(merge)
    lens = [len(t) for t in vocab]
    while len(vocab) < lay.eot:
        n = len(vocab)
        pairs = rng.integers(0, n, size=(8192, 2))
        ln = np.asarray(lens)
        pairs = pairs[ln[pairs[:, 0]] + ln[pairs[:, 1]] <= 8]
        for a, b in pairs:
            cand = vocab[a] + vocab[b]
            if cand not in seen:
                vocab.append(cand)
                lens.append(len(cand))
                seen.add(cand)
                if len(vocab) == lay.eot:
                    break
    for i in range(lay.eot, lay.n_vocab):
        if i == lay.eot:
            vocab.append(b"<|endoftext|>")
        elif i == lay.timestamp_begin:
            vocab.append(b"<|0.00|>")
        else:
            vocab.append(f"[_special_{i}]".encode())
    return vocab


_WORDS = re.compile(r"(?: [a-z]+)+")


class Encoder:
    """Byte-pair encoding by rank (the leftmost pair of lowest rank merges
    first; a piece that is itself a token stays whole), over text made of
    lower-case ASCII words each led by one space, which the GPT-2
    pre-tokenizer splits at every space."""

    def __init__(self, vocab: List[bytes], eot: int):
        self.ranks: Dict[bytes, int] = {}
        for i, tok in enumerate(vocab[:eot]):
            self.ranks.setdefault(tok, i)

    def _piece(self, piece: bytes) -> List[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best, at = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            parts[at:at + 2] = [parts[at] + parts[at + 1]]
        return [self.ranks[p] for p in parts]

    def encode(self, text: str) -> List[int]:
        if not _WORDS.fullmatch(text):
            raise ValueError("the benchmark's prompts are lower-case ASCII "
                             "words, each after one space")
        out: List[int] = []
        for word in re.findall(r" [a-z]+", text):
            out.extend(self._piece(word.encode()))
        return out


def prompt_tokens(enc: Encoder, lay: Layout, vocabulary: str, context: str,
                  n_text_ctx: int = 448) -> List[int]:
    """The decoder's prompt for a request, as the reference app builds it:
    ``<|startofprev|>`` and the tail of " <vocabulary> <context>" (at most
    n_text_ctx // 2 - 1 tokens), then ``<|startoftranscript|><|en|>
    <|transcribe|>`` (timestamps on)."""
    parts = [p.strip() for p in (vocabulary, context) if p and p.strip()]
    out: List[int] = []
    if parts:
        initial = enc.encode(" " + " ".join(parts))
        out = [lay.sot_prev] + initial[-(n_text_ctx // 2 - 1):]
    return out + [lay.sot, lay.lang_base, lay.transcribe]
