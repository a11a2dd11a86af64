"""Experts (``ops/moe.py``) against their roofline: the least time, at the
published H100 peaks, of the expert work the program's batch records
counted in the profiled batches (``BatchRecord.experts``: for each forward
and layer the real tokens each expert took; per forward and layer the
larger of the operations at 989 TFLOP/s and the bytes at 3.35 TB/s:
``benchmark/ops/moe_arith.py::expert_least_s``), over the device time of
the ``moe_`` kernels. A program without expert counts reads None."""

from benchmark.metrics_common import load
from benchmark.ops import moe_arith

UNIT = "%"
MOVES = {"chunks": "rtf"}


def read(run):
    recs = load(run, "queue_wait_ms").profiled(run)
    if not recs or not run.kernels:
        return None
    got = [r.experts for r in recs if getattr(r, "experts", None)]
    took = load(run, "moe_ms_per_step").moe_s(run.kernels)
    if not got or took <= 0:
        return None
    return 100.0 * moe_arith.records_least_s(run.cell.model, got) / took
