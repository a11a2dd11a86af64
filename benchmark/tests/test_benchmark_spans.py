"""The readers of the program's own batch records
(``nobs_whisper_torch/utils/profiling.py::BatchRecord``): on a tiny run
on the CPU, and the idle shares on records and a device trace made by
hand."""

import types

import pytest

from benchmark import harness

import tiny

STEADY = ("queue_wait_ms", "prep_ms", "step_forward_ms", "step_rules_ms",
          "step_sync_ms")


def _read(run, name):
    return harness.reader(run.cell.bench_dir, name).read(run)


@pytest.fixture(scope="module", params=["turbo-dictation", "v3-chunks"])
def served(request):
    c = tiny.cell(request.param)
    return tiny.run(c, 2**31 + 303)["run"]


def test_the_window_records_line_up_with_the_batches(served):
    recs = harness.reader(served.cell.bench_dir, "queue_wait_ms").records(
        served)
    assert recs and [r.rows for r in recs] == served.batch_sizes
    assert len(recs) == len(served.batches)
    for r, b in zip(recs, served.batches):
        assert all(w >= 0 for w in r.queue_waits_ns())
        assert r.steps == b.steps      # every row decodes sample_len steps


@pytest.mark.parametrize("name", STEADY)
def test_the_steady_readers_read(served, name):
    suffix = "dictation" if served.open_loop else "chunks"
    v = _read(served, f"{name}.{suffix}")
    assert v is not None and v >= 0, name
    if name != "step_sync_ms":
        assert v > 0, name


def test_the_idle_shares_need_a_trace(served):
    for name in ("idle_forward_share", "idle_rules_share"):
        assert _read(served, name) is None


def test_a_program_without_records_reads_none(served, monkeypatch):
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    monkeypatch.setattr(GLOBAL_PROFILER, "batch_records", None)
    for name in STEADY:
        assert _read(served, name) is None


def _by_hand(monkeypatch):
    """Two batches, the second profiled: 0-10 ms and 20-40 ms (ns from
    1e9 s); its intervals forward 20-26 ms, rules 26-30 ms, sync 30-40 ms;
    device activity 21-22 ms and 29-33 ms."""
    from nobs_whisper_torch.utils.profiling import (GLOBAL_PROFILER,
                                                    BatchRecord)
    ms, z = 1_000_000, 10**18

    def rec(i, a, b, traced):
        r = BatchRecord([(z, 0)], z + a * ms, traced)
        r.end_ns = z + b * ms
        return r
    first, second = rec(0, 0, 10, False), rec(1, 20, 40, True)
    second.intervals = [("forward", z + 20 * ms, z + 26 * ms),
                        ("rules", z + 26 * ms, z + 30 * ms),
                        ("sync", z + 30 * ms, z + 40 * ms)]
    monkeypatch.setattr(GLOBAL_PROFILER, "batch_records",
                        lambda: [first, second])
    s = z * 1e-9
    run = harness.Run(cell=tiny.cell("turbo-dictation"), seconds=1.0)
    run.batch_sizes = [1, 1]
    run.batches = [types.SimpleNamespace(profiled=False),
                   types.SimpleNamespace(profiled=True)]
    run.kernels = [("k", s + 0.021, s + 0.022), ("k", s + 0.029, s + 0.031),
                   ("k", s + 0.030, s + 0.033)]
    return run


def test_idle_shares_by_hand(monkeypatch):
    """Idle 20-21, 22-29, 33-40 ms (15 ms): forward holds 1 + 4, rules 3
    (to the resolution of seconds since 1970 in a double, ~0.1 us)."""
    run = _by_hand(monkeypatch)
    assert _read(run, "idle_forward_share.dictation") == pytest.approx(
        100 * 5 / 15, rel=1e-4)
    assert _read(run, "idle_rules_share.dictation") == pytest.approx(
        100 * 3 / 15, rel=1e-4)


def test_records_that_do_not_line_up_read_none(monkeypatch):
    run = _by_hand(monkeypatch)
    run.batch_sizes = [1, 2]
    assert _read(run, "idle_forward_share.dictation") is None
