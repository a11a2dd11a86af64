"""Device: the share of the profiled batches' walls in which no device
activity ran (1 - the union of the activities' intervals, summed over the
batches, / the batches' summed walls)."""

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    if not run.kernels or not run.span_s:
        return None
    return 100.0 * max(0.0, 1.0 - run.busy_s / run.span_s)
