"""The port's BPE text encoder (``nobs_whisper_torch/core/tokenizer.py``)
against the JAX package's ``WhisperTokenizer.encode``, which runs
``tiktoken`` with ``_PAT``: token-equal on strings that hit each branch of
the pattern and each known trap, under hypothesis over arbitrary text, and
with every code point of the assigned planes classed as tiktoken's regex
classes it. Encoding imports neither ``tiktoken`` nor ``regex``."""

import os
import subprocess
import sys

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nobs_whisper_torch.core.config import get_config
from nobs_whisper_torch.core.tokenizer import (WhisperTokenizer, char_class,
                                               pretokenize)
from nobs_whisper_torch.utils.testing import byte_level_vocab, tiny_test_config

torch.set_num_threads(1)   # xdist runs 6 workers on 8 cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(cfg):
    from nobs_whisper_tpu.core.tokenizer import WhisperTokenizer as Ref
    vocab = byte_level_vocab(cfg)
    return Ref(vocab, cfg), WhisperTokenizer(vocab, cfg)


@pytest.fixture(scope="module")
def tiny():
    return _pair(tiny_test_config())


@pytest.fixture(scope="module")
def turbo():
    return _pair(get_config("large-v3-turbo"))


# one string per branch of _PAT and per trap of tiktoken's regex
FIXED = [
    # contractions: each one, case-sensitive, ASCII apostrophe only
    "it's", "don't", "we're", "they've", "I'm", "we'll", "he'd",
    "IT'S DON'T", "it’s", "''s", "'sup", " 's", "x'", "'",
    # letters, numbers, "other" runs, each with and without one space
    "hello", " hello", "  hello", "12345", " 12345", "a1b2", "٣٤",
    "?!.,", " ?!", "...hello...", "½", "Ⅷ",
    # white space: \s+(?!\S) backtracks one character before a non-space
    "a   b", "a \t b", "a\n\nb", "a \n b", "end   ", "   ", "\t\tx",
    "  x", "　　y", "a b", "a\u0085b",
    # str.isspace() is true for U+001C-U+001F; \s (White_Space) is not
    "a\x1cb", "x\x1d\x1e\x1fy", " \x1f", "\x1c\x1c",
    # combining marks (Mn) and emoji fall into the "other" branch
    "e\u0301te\u0301", "\u00e9t\u00e9", "café ok", "hi \U0001F600!", "\U0001F44D\U0001F3FD",
    "אָב", "क्ष",
    # letters Python's Unicode 15.0 calls unassigned (Unicode 15.1/16.0)
    "a\U0002EBF0b", "x\U00010D40y", " \U000105C0\U000105C1",
    # lone surrogates are replaced as tiktoken's Encoding.encode does
    "ab\ud800cd", "\udfff",
    # mixed
    "GitHub, VSCode, Python, JavaScript, pull request",
    " 你好，世界。 Olá مرحبا",
    "",
]


@pytest.mark.parametrize("text", FIXED)
def test_fixed_strings_match_tiktoken(tiny, turbo, text):
    for ref, tok in (tiny, turbo):
        assert tok.encode(text) == ref.encode(text)


def test_pretokenize_traps():
    assert pretokenize("a   b") == ["a", "  ", " b"]
    assert pretokenize("a\x1cb") == ["a", "\x1c", "b"]
    assert pretokenize("it's IT'S") == ["it", "'s", " IT", "'", "S"]
    assert pretokenize("e\u0301!") == ["e", "\u0301!"]
    assert pretokenize("x \n y") == ["x", " \n", " y"]


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text())
def test_hypothesis_text_matches_tiktoken_tiny(tiny, text):
    ref, tok = tiny
    assert tok.encode(text) == ref.encode(text)


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text())
def test_hypothesis_text_matches_tiktoken_turbo(turbo, text):
    ref, tok = turbo
    assert tok.encode(text) == ref.encode(text)


@settings(max_examples=200, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(alphabet=st.sampled_from(
    list("ab1 'sSrRvVmMlLdDtT\t\n\x1c\xa0\u0301\u3000.!") + ["\U0001F600"]),
    max_size=40))
def test_hypothesis_dense_traps_match_tiktoken(tiny, text):
    """Short alphabets make the pattern's edges (apostrophes, space runs,
    class changes) dense, where st.text() rarely lands on them."""
    ref, tok = tiny
    assert tok.encode(text) == ref.encode(text)


def _tiktoken_classes(cps):
    """Each code point's class as tiktoken's pre-tokenizer sees it, read
    off its output: with "a"+c, "1"+c and c+c in the ranks, "a"+c is one
    token only if c is a letter, "1"+c only if a number, and "x"+c+c+"y"
    holds the c+c token only if c is "other" (a white-space pair before
    "y" is split by the regex's backtrack)."""
    import tiktoken
    from nobs_whisper_torch.core.tokenizer import _PAT
    ranks = {bytes([i]): i for i in range(256)}
    for cp in cps:
        for s in ("a" + chr(cp), "1" + chr(cp), chr(cp) * 2):
            ranks.setdefault(s.encode(), len(ranks))
    enc = tiktoken.Encoding(name="probe", pat_str=_PAT,
                            mergeable_ranks=ranks, special_tokens={})
    out = {}
    for cp in cps:
        c = chr(cp)
        if len(enc.encode("a" + c)) == 1:
            out[cp] = "L"
        elif len(enc.encode("1" + c)) == 1:
            out[cp] = "N"
        elif ranks[(c + c).encode()] in enc.encode("x" + c + c + "y"):
            out[cp] = "O"
        else:
            out[cp] = "S"
    return out


@pytest.mark.parametrize("lo,hi", [(0x0, 0x10000), (0x10000, 0x20000),
                                   (0x20000, 0x40000), (0xE0000, 0xE1000)])
def test_every_code_point_classed_as_tiktoken(lo, hi):
    """Every code point of planes 0-3 and 14 (all assigned characters of
    Unicode 16.0; planes 15-16 are private use, "other" to both) gets the
    class the regex crate's tables give it, including those that Python's
    older ``unicodedata`` does not know."""
    cps = [cp for cp in range(lo, hi) if not 0xD800 <= cp < 0xE000]
    want = _tiktoken_classes(cps)
    bad = {hex(cp): (char_class(chr(cp)), k) for cp, k in want.items()
           if char_class(chr(cp)) != k}
    assert not bad, list(bad.items())[:20]


@pytest.mark.parametrize("blocked", [False, True])
def test_encode_imports_neither_tiktoken_nor_regex(blocked):
    """In a fresh interpreter, building the tokenizer and encoding text
    (every branch, the non-speech table) leaves ``tiktoken`` and ``regex``
    unimported; with both made unimportable it gives the same ids."""
    code = f"""
import sys
if {blocked}:
    sys.modules["tiktoken"] = sys.modules["regex"] = None
from nobs_whisper_torch.core.tokenizer import WhisperTokenizer
from nobs_whisper_torch.utils.testing import byte_level_vocab, tiny_test_config
cfg = tiny_test_config()
tok = WhisperTokenizer(byte_level_vocab(cfg), cfg)
text = " it's 12 apples?!  \\u00e9\\U0001F600 ok\\n"
ids = tok.encode(text)
assert ids and tok.decode(ids) == text
assert tok.non_speech_tokens
if not {blocked}:
    assert "tiktoken" not in sys.modules and "regex" not in sys.modules
print(ids)
"""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    from nobs_whisper_tpu.core.tokenizer import WhisperTokenizer as Ref
    cfg = tiny_test_config()
    ref = Ref(byte_level_vocab(cfg), cfg)
    want = ref.encode(" it's 12 apples?!  \u00e9\U0001F600 ok\n")
    assert out.stdout.strip() == str(want)


def test_non_speech_tokens_match_reference(tiny, turbo):
    for ref, tok in (tiny, turbo):
        assert tok.non_speech_tokens == ref.non_speech_tokens
