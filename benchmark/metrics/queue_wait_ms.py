"""Engine / batcher (``pipeline/batcher.py``): a request's wait in the
batcher's queue, from the program's own batch records
(``nobs_whisper_torch/utils/profiling.py::BatchRecord``): the median over
the steady batches' rows (in a traced run those before the profiler's
first, ``harness.Run.steady``) of the batch's start minus the request's
submit stamp.

The window's batches are the program's last ``len(run.batch_sizes)``
records (the warm batches come before them); a program whose records'
rows differ from ``run.batch_sizes``, or that keeps none, reads None.
The other readers of the records take them from here."""

import statistics

UNIT = "ms"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def records(run):
    """The window's batch records, in the order the batches ended, or
    None."""
    from nobs_whisper_torch.utils.profiling import GLOBAL_PROFILER
    kept = getattr(GLOBAL_PROFILER, "batch_records", None)
    n = len(run.batch_sizes)
    if kept is None or not n:
        return None
    recs = kept()[-n:]
    if [r.rows for r in recs] != list(run.batch_sizes):
        return None
    return recs


def steady(run):
    recs = records(run)
    return None if recs is None else recs[:len(run.steady)]


def profiled(run):
    recs = records(run)
    if recs is None or len(recs) != len(run.batches):
        return None
    return [r for r, b in zip(recs, run.batches) if b.profiled]


def read(run):
    waits = [w for r in steady(run) or () for w in r.queue_waits_ns()]
    return statistics.median(waits) * 1e-6 if waits else None
