"""Median latency over every request sent, from its due time to
its answer (an open loop's wait behind a stall counts); a request that
failed or never returned counts as missing every limit. In a traced run,
over the requests due before the profiler's first batch
(``Run.steady_records``)."""

from benchmark.traffic import percentile

UNIT = "ms"
P = 50
MOVES = {}


def read(run):
    if not run.open_loop:
        return None
    return percentile([(r.done - r.due) * 1e3 if r.ok else float("inf")
                       for r in run.steady_records], P)
