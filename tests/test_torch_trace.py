"""The port's tracer (``nobs_whisper_torch/utils/profiling.py``) on the
CPU: the batch records that ``WindowBatcher`` leaves for every batch, on
a tiny model through ``BatchedEngine``, and the stage aggregates beside
them."""

import threading
import time

import numpy as np
import pytest
import torch

from nobs_whisper_torch.utils.profiling import (GLOBAL_PROFILER, PARTS,
                                                Profiler)

SAMPLE_LEN = 20
EXIT_CHECK = 8          # decode/greedy.py::_EXIT_CHECK


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    from nobs_whisper_torch.api import WhisperEngine
    from nobs_whisper_torch.utils.testing import write_tiny_checkpoint
    path = str(tmp_path_factory.mktemp("m") / "m.bin")
    write_tiny_checkpoint(path)
    return WhisperEngine.from_ggml(path, dtype=torch.float32, device="cpu")


def _batched(engine, max_batch=4, max_wait_ms=200.0):
    from nobs_whisper_torch.decode.rules import DecodeOptions
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    return BatchedEngine(engine, opts=DecodeOptions(
        sample_len=SAMPLE_LEN, temperature_increment=0.0),
        max_batch=max_batch, max_wait_ms=max_wait_ms)


def _audio(i, seconds=1.0):
    """Shorter than the tiny model's 1.28 s window: one window a request."""
    rng = np.random.RandomState(i)
    return (rng.randn(int(16000 * seconds)) * 0.2).astype(np.float32)


def _serve(be, n):
    """``n`` requests at once; the records of the batches they made."""
    before = len(be.batcher.batch_sizes)
    threads = [threading.Thread(target=be.transcribe, args=(_audio(i),),
                                kwargs=dict(language="en"))
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    made = len(be.batcher.batch_sizes) - before
    recs = GLOBAL_PROFILER.batch_records()[-made:]
    assert [r.rows for r in recs] == be.batcher.batch_sizes[before:]
    return recs


@pytest.fixture(scope="module")
def served(engine):
    """Six requests through a batcher of four rows: two batches or more,
    no profiler."""
    be = _batched(engine)
    t0 = time.time_ns()
    try:
        recs = _serve(be, 6)
    finally:
        be.close()
    return t0, recs


def test_queue_wait_ends_at_the_batch_start(served):
    t0, recs = served
    assert len(recs) >= 2
    for r in recs:
        for (t_submit, prep), w in zip(r.requests, r.queue_waits_ns()):
            assert t0 < t_submit <= r.start_ns
            assert w >= 0 and t_submit + w == r.start_ns
            assert prep > 0               # framing and the prompt
    assert sum(r.rows for r in recs) == 6


def test_parts_fit_in_the_batch(served):
    """Every part runs but ``capture``: the CPU runs the steps eagerly."""
    for r in served[1]:
        wall = r.end_ns - r.start_ns
        assert set(r.ns) == set(PARTS)
        assert 0 < sum(r.ns.values()) <= wall
        assert all(r.calls[p] >= 1 and r.ns[p] > 0
                   for p in PARTS if p != "capture")
        assert r.calls["capture"] == r.ns["capture"] == r.replays == 0


def test_step_parts_count_the_decode_steps(served):
    """``forward`` once a step but the last of a loop that ran to
    ``sample_len``; ``sync`` once an exit check and once for the results'
    copies."""
    for r in served[1]:
        steps = r.steps
        assert 0 < steps <= SAMPLE_LEN
        full = steps == SAMPLE_LEN
        assert r.calls["forward"] == (steps - 1 if full else steps)
        checks = (SAMPLE_LEN - 1 if full else steps) // EXIT_CHECK
        assert r.calls["sync"] == checks + 1
        assert r.calls["finalize"] == 1 and r.calls["stack"] == 1


def test_without_a_profiler_no_intervals(served):
    assert all(r.intervals is None for r in served[1])


def _profiled_batch(engine, activities):
    """One request whose batch runs under ``torch.profiler`` started in
    the batch's own thread (as the benchmark's traced run starts it):
    (its record, the profiler)."""
    from torch.profiler import profile
    be = _batched(engine, max_wait_ms=5.0)
    run_batch, got = be.batcher._run_batch, {}

    def profiled(batch):
        with profile(activities=activities) as prof:
            run_batch(batch)
        got["prof"] = prof
    be.batcher._run_batch = profiled
    try:
        [rec] = _serve(be, 1)
    finally:
        be.close()
    return rec, got["prof"]


def test_a_profiled_batch_keeps_its_intervals_on_the_profilers_clock(
        engine):
    """Intervals are kept under a CPU profiler, in order, inside the
    batch, adding up to each part's sum; every CPU op event of the batch
    lies inside the record, and each argmax (the greedy step's pick)
    inside a ``rules`` interval: the stamps share the profiler's clock."""
    from torch.profiler import ProfilerActivity
    rec, prof = _profiled_batch(engine, [ProfilerActivity.CPU])
    iv = rec.intervals
    assert iv and len(iv) == sum(rec.calls.values())
    assert all(a[2] <= b[1] for a, b in zip(iv, iv[1:]))
    assert rec.start_ns <= iv[0][1] and iv[-1][2] <= rec.end_ns
    for p in PARTS:
        assert sum(e - s for q, s, e in iv if q == p) == rec.ns[p]
    events = [(e.name(), e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events()]
    assert len(events) > 100
    for _, s, e in events:
        assert rec.start_ns <= s <= e <= rec.end_ns
    rules = [(s, e) for p, s, e in iv if p == "rules"]
    picks = [(s, e) for name, s, e in events if name == "aten::argmax"]
    assert len(picks) >= len(rules) == rec.steps
    for s, e in picks:
        assert any(a <= s and e <= b for a, b in rules)


def test_records_are_published_in_the_order_batches_end():
    """A batch that starts first and ends last is published last; the
    thread-local record is the running batch's own."""
    from nobs_whisper_torch.utils.profiling import NO_RECORD, batch_record
    prof = Profiler()
    first_open, first_may_end = threading.Event(), threading.Event()
    seen = {}

    def first():
        with prof.batch([(0, 0)]) as rec:
            seen["first"] = batch_record() is rec
            first_open.set()
            first_may_end.wait(10)

    t1 = threading.Thread(target=first)
    t1.start()
    assert first_open.wait(10)
    with prof.batch([(0, 0), (0, 0)]) as rec:
        seen["second"] = batch_record() is rec
    first_may_end.set()
    t1.join(timeout=10)
    assert not t1.is_alive()
    assert seen == {"first": True, "second": True}
    assert batch_record() is NO_RECORD
    recs = prof.batch_records()
    assert [r.rows for r in recs] == [2, 1]
    assert recs[0].start_ns > recs[1].start_ns
    assert recs[0].end_ns <= recs[1].end_ns


def test_a_batch_that_raises_is_published():
    prof = Profiler()
    with pytest.raises(RuntimeError):
        with prof.batch([(0, 0)]) as rec:
            rec.add("stack", rec.start_ns)
            raise RuntimeError("decode failed")
    [got] = prof.batch_records()
    assert got is rec and got.calls["stack"] == 1
    assert got.start_ns <= got.end_ns


def test_stage_aggregates_are_unchanged():
    """``stage``/``stage_timer`` and ``record`` sum count, total and the
    longest duration a name, as before the batch records."""
    prof = Profiler()
    with prof.stage("mel"):
        time.sleep(0.01)
    prof.record("first_partial", 0.5)
    prof.record("first_partial", 0.25)
    snap = prof.snapshot()
    assert snap["mel"]["count"] == 1
    assert 0.01 <= snap["mel"]["total_s"] == snap["mel"]["max_s"]
    assert snap["first_partial"] == {"count": 2, "total_s": 0.75,
                                     "max_s": 0.5, "mean_s": 0.375}
    assert not prof.batch_records() and not prof.batch_summary()


def test_batch_records_leave_the_stage_aggregate_alone(engine):
    """A batch through the batcher adds its record and no stage name
    (``/stats`` shows its parts under ``batcher.step_ms``)."""
    before = set(GLOBAL_PROFILER.snapshot())
    be = _batched(engine, max_wait_ms=5.0)
    try:
        [rec] = _serve(be, 1)
    finally:
        be.close()
    assert set(GLOBAL_PROFILER.snapshot()) == before
    assert GLOBAL_PROFILER.batch_records()[-1] is rec


def test_batch_summary_reads_the_recent_batches():
    """Only the last ``SUMMARY_BATCHES`` batches count."""
    from nobs_whisper_torch.utils.profiling import SUMMARY_BATCHES
    prof = Profiler()
    ms = 1_000_000
    for wait in [1000] * 5 + [10] * SUMMARY_BATCHES:
        with prof.batch([(-wait * ms, 0)]) as rec:
            rec.start_ns = 0
    got = prof.batch_summary()
    assert got == {"queue_wait_ms": {"p50": 10.0, "p95": 10.0}}


def test_batch_summary_by_hand():
    """Two batches of four steps: one eager (four rules passes, three
    forwards), one whose first three steps replayed a captured graph."""
    prof = Profiler()
    ms = 1_000_000
    for waits, fwd, rules, capture, replays in (((10, 30), 8, 2, 0, 0),
                                                ((20,), 4, 2, 4, 3)):
        with prof.batch([(-w * ms, 0) for w in waits]) as rec:
            rec.start_ns = 0
            rec.ns.update(forward=fwd * ms, rules=rules * ms,
                          capture=capture * ms)
            rec.calls.update(rules=4 - replays, forward=3)
            rec.replays = replays
            assert rec.steps == 4
    got = prof.batch_summary()
    assert got["queue_wait_ms"] == {"p50": 20.0, "p95": pytest.approx(29.0)}
    assert got["step_ms"] == {"forward": 1.5, "rules": 0.5, "sync": 0.0,
                              "capture": 0.5, "replayed_share": 0.5}
