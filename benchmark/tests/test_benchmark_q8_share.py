"""The reader of the decode steps' int8 linears run on K6
(``metrics/q8_step_share.py``): on a tiny run on the CPU, which keeps
every int8 linear on the dequant path, and on records made by hand."""

import collections
import types

import pytest

from benchmark import harness

import tiny


def _read(run, name):
    return harness.reader(run.cell.bench_dir, name).read(run)


@pytest.fixture(scope="module", params=["turbo-dictation", "v3-chunks"])
def served(request):
    return tiny.run(tiny.cell(request.param), 2**31 + 505)["run"]


def test_the_cpu_runs_no_step_on_k6(served):
    suffix = "dictation" if served.open_loop else "chunks"
    assert _read(served, f"q8_step_share.{suffix}") == 0.0


def _records(monkeypatch, routes, keep_routes=True):
    """Steady batches made by hand, one a {route: linears} dict (a
    replayed step's linears counted once a replay), the last one
    profiled."""
    from nobs_whisper_torch.utils.profiling import (GLOBAL_PROFILER,
                                                    BatchRecord)
    recs = []
    for r in routes:
        rec = BatchRecord([(0, 0)], 0, False)
        rec.q8_linears.update(r)
        recs.append(rec)
    if not keep_routes:
        recs = [types.SimpleNamespace(rows=1, calls=r.calls) for r in recs]
    monkeypatch.setattr(GLOBAL_PROFILER, "batch_records", lambda: recs)
    run = harness.Run(cell=tiny.cell("v3-chunks"), seconds=1.0)
    run.batch_sizes = [1] * len(recs)
    run.batches = [types.SimpleNamespace(profiled=i == len(recs) - 1)
                   for i in range(len(recs))]
    return run


# 257 linears a step at v3's 32 layers; the profiled batch is not read
@pytest.mark.parametrize("routes,share", [
    (({"K6": 257 * 127}, {"K6": 257 * 127}, {"dequant": 257}), 100.0),
    # replays weigh by the steps they ran: 127 on K6, 31 dequantized
    (({"K6": 257 * 127}, {"dequant": 257 * 31}, {}), 100.0 * 127 / 158),
    (({"dequant": 257 * 46}, {"K6": 257, "dequant": 257 * 3}, {}), 2.0),
])
def test_q8_step_share_by_hand(monkeypatch, routes, share):
    run = _records(monkeypatch, routes)
    assert _read(run, "q8_step_share.chunks") == pytest.approx(share)


def test_records_without_routes_read_none(monkeypatch):
    """A program that counts no routes (one from before the counter), and
    a model whose decode steps run no int8 linear."""
    run = _records(monkeypatch, ({"K6": 1}, {"K6": 1}), keep_routes=False)
    assert _read(run, "q8_step_share.chunks") is None
    run = _records(monkeypatch, ({}, {}))
    assert _read(run, "q8_step_share.chunks") is None


def test_the_record_counts_each_replay(monkeypatch):
    """A step captured once and replayed three times adds its linears to
    the batch record three times (``ops/_build.py::LaunchTally``)."""
    from nobs_whisper_torch.ops import _build
    from nobs_whisper_torch.utils.profiling import BatchRecord
    rec = BatchRecord([(0, 0)], 0, False)
    tally = _build.LaunchTally()
    with tally:
        _build.count(rec.q8_linears, "K6", 257)
    assert rec.q8_linears == collections.Counter()
    for _ in range(3):
        tally.replay()
    assert rec.q8_linears == {"K6": 3 * 257}
