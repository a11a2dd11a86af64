"""Engine / batcher (``pipeline/batched_engine.py``, ``pipeline/batcher.py``):
rows a batch, from the window's batcher's counter
``WindowBatcher.batch_sizes``, over the run's steady batches (in a traced
run those before the profiler's first, ``harness.Run.steady``)."""

UNIT = "rows"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    sizes = run.batch_sizes[:len(run.steady)]
    if not sizes:
        return None
    return sum(sizes) / len(sizes)
