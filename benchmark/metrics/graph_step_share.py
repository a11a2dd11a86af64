"""Decoder loop (``decode/greedy.py::decode_window_impl``): the share of
the decode steps with a forward whose forward ran as a replay of the
batch's CUDA graph, from the program's batch records
(``BatchRecord.replays`` over the ``forward`` part's calls), over the
steady batches. A program whose records count no replays reads None."""

from benchmark.metrics_common import load

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    recs = load(run, "queue_wait_ms").steady(run)
    if not recs or not all(hasattr(r, "replays") for r in recs):
        return None
    forwards = sum(r.calls["forward"] for r in recs)
    if not forwards:
        return None
    return 100.0 * sum(r.replays for r in recs) / forwards
