"""Window program (``decode/greedy.py``): the host time a decode step
spends blocked on the device (``sync``: the copy before the loop that
waits for the encoder and the prefill enqueued before it, the exit check
every 8 steps, the results' copies to the host in
``decode_window_finalize``), over the steady batches' decode steps, as
``step_forward_ms``."""

from benchmark.metrics_common import load

UNIT = "ms/step"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    return load(run, "step_forward_ms").per_step(run, "sync")
