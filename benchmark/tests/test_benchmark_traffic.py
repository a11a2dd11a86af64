"""The traffic generator and the end-to-end arithmetic."""

import json
import math
import os

import numpy as np
import pytest

from benchmark import harness, traffic
from benchmark.reference.tokens import Encoder, byte_level_vocab, layout

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def enc():
    lay = layout(51866)
    return Encoder(byte_level_vocab(lay), lay.eot)


def _mix(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mix", ["dictation", "chunks32"])
def test_same_seed_same_requests(mix, enc):
    a = traffic.make_requests(_mix(mix), 2**31 + 17, 10.0, enc)
    b = traffic.make_requests(_mix(mix), 2**31 + 17, 10.0, enc)
    assert [(r.due_s, r.offset, r.length, r.vocabulary, r.context)
            for r in a] == [(r.due_s, r.offset, r.length, r.vocabulary,
                             r.context) for r in b]
    assert all(np.array_equal(x.audio, y.audio) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["dictation", "chunks32"])
def test_seeds_share_the_sizes(mix, enc):
    """Another seed orders the same sizes and gaps differently."""
    a = traffic.make_requests(_mix(mix), 5, 10.0, enc)
    b = traffic.make_requests(_mix(mix), 6, 10.0, enc)
    assert sorted(r.length for r in a) == sorted(r.length for r in b)
    assert [r.length for r in a] != [r.length for r in b]
    gaps = lambda rs: sorted(np.round(np.diff([0.0] + [r.due_s for r in rs]),
                                      9))
    assert gaps(a) == gaps(b)


def test_open_loop_fills_the_window_at_its_rate(enc):
    mix = _mix("dictation")
    reqs = traffic.make_requests(mix, 11, 30.0, enc)
    assert len(reqs) == round(mix["rate_per_s"] * 30.0)
    due = [r.due_s for r in reqs]
    assert 0.0 < due[0] and due == sorted(due) and due[-1] < 30.0
    assert len(reqs) / 30.0 == pytest.approx(mix["rate_per_s"], rel=0.02)
    lo, hi = mix["length_s"]["min"], mix["length_s"]["max"]
    assert all(lo * 16000 <= r.length <= hi * 16000 for r in reqs)
    med = np.median([r.seconds for r in reqs])
    assert med == pytest.approx(mix["length_s"]["median"], rel=0.05)


def test_prompt_sizes_are_tokens(enc):
    mix = _mix("chunks32")
    reqs = traffic.make_requests(mix, 3, 10.0, enc)
    for r in reqs:
        n = len(enc.encode(" " + r.context))
        assert mix["context_tokens"]["min"] <= n
        assert n <= mix["context_tokens"]["max"] + 8   # the last word's
        assert r.vocabulary == ""


def test_percentile_is_over_every_request():
    """Failures count as missing every limit; nearest rank."""
    v = list(range(1, 101))
    assert traffic.percentile(v, 50) == 50
    assert traffic.percentile(v, 95) == 95
    assert traffic.percentile(v[:94] + [math.inf] * 6, 95) == math.inf
    assert traffic.percentile([], 50) == math.inf


def _run(open_loop, recs):
    cell = harness.Cell(name="x", chips=1, model={}, mix={}, limits={},
                        metrics=[], bench_dir=BENCH)
    r = harness.Run(cell=cell, seconds=10.0, open_loop=open_loop)
    r.records = recs
    return r


def _sent(due, done, seconds=10.0, ok=True):
    req = traffic.Request(index=0, due_s=due, offset=0,
                          length=int(seconds * 16000), vocabulary="",
                          context="")
    return harness.Sent(req=req, due=due, sent=due, done=done,
                        served=[1] if ok else None,
                        error=None if ok else "x")


def test_latency_runs_from_the_due_time():
    recs = [_sent(0.0, 1.0), _sent(1.0, 1.5), _sent(2.0, 4.0),
            _sent(3.0, 3.0, ok=False)]
    run = _run(True, recs)
    p50 = harness.reader(BENCH, "latency_p50_ms").read(run)
    p95 = harness.reader(BENCH, "latency_p95_ms").read(run)
    assert p50 == pytest.approx(1000.0)      # 500, 1000, 2000, inf
    assert p95 == math.inf


def test_rtf_counts_the_drain():
    """Audio of every answered request over the time to the last answer,
    the requests in flight at the close included."""
    recs = [_sent(math.nan, 4.0, 20.0), _sent(math.nan, 9.0, 20.0),
            _sent(math.nan, 12.5, 10.0), _sent(math.nan, 12.5, 5.0,
                                               ok=False)]
    run = _run(False, recs)
    assert harness.reader(BENCH, "rtf").read(run) == pytest.approx(50 / 12.5)
    assert harness.reader(BENCH, "latency_p50_ms").read(run) is None
