"""The reader of the decode steps replayed from a CUDA graph
(``metrics/graph_step_share.py``): on a tiny run on the CPU, which runs
every step eagerly, and on records made by hand."""

import types

import pytest

from benchmark import harness

import tiny


def _read(run, name):
    return harness.reader(run.cell.bench_dir, name).read(run)


@pytest.fixture(scope="module", params=["turbo-dictation", "v3-chunks"])
def served(request):
    return tiny.run(tiny.cell(request.param), 2**31 + 404)["run"]


def test_the_cpu_replays_no_step(served):
    suffix = "dictation" if served.open_loop else "chunks"
    assert _read(served, f"graph_step_share.{suffix}") == 0.0


def _records(monkeypatch, replays, forwards, keep_replays=True):
    """Steady batches made by hand, one a (replays, forwards) pair, the
    last one profiled."""
    from nobs_whisper_torch.utils.profiling import (GLOBAL_PROFILER,
                                                    BatchRecord)
    recs = []
    for r, f in zip(replays, forwards):
        rec = BatchRecord([(0, 0)], 0, False)
        rec.calls["forward"], rec.replays = f, r
        recs.append(rec)
    if not keep_replays:
        recs = [types.SimpleNamespace(rows=1, calls=r.calls) for r in recs]
    monkeypatch.setattr(GLOBAL_PROFILER, "batch_records", lambda: recs)
    run = harness.Run(cell=tiny.cell("v3-chunks"), seconds=1.0)
    run.batch_sizes = [1] * len(recs)
    run.batches = [types.SimpleNamespace(profiled=i == len(recs) - 1)
                   for i in range(len(recs))]
    return run


@pytest.mark.parametrize("replays,forwards,share", [
    ((47, 47, 0), (47, 47, 47), 100.0),      # the profiled batch not read
    ((47, 0, 5), (47, 47, 47), 50.0),
    ((0, 0, 0), (47, 47, 47), 0.0),
])
def test_graph_step_share_by_hand(monkeypatch, replays, forwards, share):
    run = _records(monkeypatch, replays, forwards)
    assert _read(run, "graph_step_share.chunks") == pytest.approx(share)


def test_records_without_replays_read_none(monkeypatch):
    """A program that counts no replays (one from before the graph)."""
    run = _records(monkeypatch, (1, 1), (1, 1), keep_replays=False)
    assert _read(run, "graph_step_share.chunks") is None
    run = _records(monkeypatch, (0, 0), (0, 0))
    assert _read(run, "graph_step_share.chunks") is None
