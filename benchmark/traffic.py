"""The general traffic generator: a mix file (``benchmark/traffic/<mix>.json``)
in, the run's requests out.

Every seed gets the same multiset of sizes and arrival gaps: each size is
the quantile (i + 0.5) / n of the mix's distribution, and the seed only
orders them and fills in the content (which words, which slice of the
audio tape), so that runs with different seeds do the same work.

Kinds of mix:

* ``open_poisson``: n = ``rate_per_s`` x seconds requests, due at
  exponential gaps (n quantiles of the exponential, in the seed's order,
  the first before the first request), scaled so that n + 1 mean gaps fill
  the window; each is sent at its due time whatever the system is doing.
* ``closed_loop``: ``clients`` clients, each sending its next request when
  its last returns, from a pool of ``pool`` requests; client c's k-th
  request is pool entry (c + clients k) mod pool.

Distributions (``{"dist": ...}``): ``fixed`` (``value``), ``uniform``
(``min``, ``max``), ``lognormal`` (``median``, ``sigma``, clipped to
``min``, ``max``). Prompt sizes are in tokens of the benchmark's
vocabulary: a prompt is made of random lower-case words whose token
counts add up to at least its size.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

import numpy as np

from .audio import SAMPLE_RATE, tape
from .reference.tokens import Encoder


@dataclasses.dataclass
class Request:
    index: int
    due_s: float                  # open loop: due time from the window start
    offset: int                   # first sample of the tape
    length: int                   # samples
    vocabulary: str
    context: str
    audio: np.ndarray = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return self.length / SAMPLE_RATE


def quantiles(spec: Dict, n: int) -> np.ndarray:
    """The n quantiles (i + 0.5) / n of a distribution spec."""
    q = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "fixed":
        return np.full(n, float(spec["value"]))
    if kind == "uniform":
        return spec["min"] + q * (spec["max"] - spec["min"])
    if kind == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
        v = spec["median"] * np.exp(spec["sigma"] * z)
        return np.clip(v, spec["min"], spec["max"])
    raise ValueError(f"unknown distribution {kind!r}")


def _words(rng: np.random.Generator, n: int) -> List[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    return ["".join(rng.choice(letters, size=int(rng.integers(2, 9))))
            for _ in range(n)]


class _Prompts:
    """Random word sequences of a given size in tokens."""

    def __init__(self, rng: np.random.Generator, enc: Encoder):
        self.rng = rng
        self.words = _words(rng, 512)
        self.cost = [len(enc.encode(" " + w)) for w in self.words]

    def make(self, n_tokens: int) -> str:
        out, have = [], 0
        while have < n_tokens:
            i = int(self.rng.integers(len(self.words)))
            out.append(self.words[i])
            have += self.cost[i]
        return " ".join(out)


def n_requests(mix: Dict, seconds: float) -> int:
    if mix["kind"] == "open_poisson":
        return max(1, int(round(mix["rate_per_s"] * seconds)))
    return int(mix["pool"])


def make_requests(mix: Dict, seed: int, seconds: float,
                  enc: Encoder) -> List[Request]:
    """The run's requests (open loop: in due order; closed loop: the
    pool), each with its audio sliced from the run's tape."""
    n = n_requests(mix, seconds)
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(quantiles(mix["length_s"], n))
    ctx = rng.permutation(quantiles(mix["context_tokens"], n))
    voc = rng.permutation(quantiles(mix["vocabulary_tokens"], n))
    if mix["kind"] == "open_poisson":
        gaps = rng.permutation(-np.log(1.0 - (np.arange(n) + 0.5) / n))
        due = np.cumsum(gaps) * (seconds * n / ((n + 1) * gaps.sum()))
    else:
        due = np.zeros(n)
    tape_s = float(mix.get("tape_s", 120.0))
    audio = tape(tape_s, seed)
    prompts = _Prompts(rng, enc)
    out = []
    for i in range(n):
        length = int(round(lengths[i] * SAMPLE_RATE))
        offset = int(rng.integers(0, audio.size - length + 1))
        out.append(Request(
            index=i, due_s=float(due[i]), offset=offset, length=length,
            vocabulary=prompts.make(int(round(voc[i]))),
            context=prompts.make(int(round(ctx[i]))),
            audio=audio[offset:offset + length]))
    return out


def percentile(values: List[float], p: float) -> float:
    """The p-th percentile (nearest rank) of ``values``; an infinite value
    stands for a request that failed or never returned."""
    if not values:
        return math.inf
    v = sorted(values)
    k = max(0, min(len(v) - 1, math.ceil(p / 100.0 * len(v)) - 1))
    return v[k]
