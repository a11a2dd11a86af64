"""Window program (``decode/greedy.py::decode_window_dispatch``): host
wall a decode step, over the run's steady batches (in a traced run those
before the profiler's first, ``harness.Run.steady``): the benchmark's span
around each batch the batcher runs (framing, mel, encoder, prefill, the
step loop, the results on the host), summed, over the decode steps
summed."""

UNIT = "ms/step"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    steps = sum(b.steps for b in run.steady)
    if not steps:
        return None
    return sum(b.end - b.start for b in run.steady) * 1e3 / steps
