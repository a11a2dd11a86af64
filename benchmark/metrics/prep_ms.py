"""Engine / batcher (``pipeline/batched_engine.py::BatchedEngine.
transcribe``): a request's preparation on its caller's thread (framing
the audio, the prompt's tokens) before it is submitted, from the
program's batch records: the median over the steady batches' rows."""

import statistics

from benchmark.metrics_common import load

UNIT = "ms"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    recs = load(run, "queue_wait_ms").steady(run)
    prep = [p for r in recs or () for _, p in r.requests]
    return statistics.median(prep) * 1e-6 if prep else None
