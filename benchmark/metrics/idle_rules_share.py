"""Device: of the device's idle time inside the profiled batches' records,
the share during which the host ran the logit rules, sampling and the
step's bookkeeping (the records' ``rules`` intervals), as
``idle_forward_share``."""

from benchmark.metrics_common import load

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    return load(run, "idle_forward_share").idle_share(run, "rules")
