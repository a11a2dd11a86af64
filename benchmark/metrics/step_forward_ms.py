"""Decoder loop (``decode/greedy.py::decode_window_impl``): the host time
a decode step spends enqueueing ``decoder_forward``, from the program's
batch records: the steady batches' summed ``forward`` part over their
summed decode steps (a step is a pass of the loop: 48 a dictation batch,
128 a chunk batch; the last step needs no forward)."""

from benchmark.metrics_common import load

UNIT = "ms/step"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def per_step(run, part):
    """ms of ``part`` a decode step over the steady batches, or None."""
    recs = load(run, "queue_wait_ms").steady(run)
    steps = sum(r.steps for r in recs or ())
    if not steps:
        return None
    return sum(r.ns[part] for r in recs) * 1e-6 / steps


def read(run):
    return per_step(run, "forward")
