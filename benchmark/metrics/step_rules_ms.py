"""Decoder loop (``decode/greedy.py::decode_window_impl``,
``decode/rules.py``): the host time a decode step spends on the logit
rules, the argmax or sampling and the step's bookkeeping (``rules``),
over the steady batches' decode steps, as ``step_forward_ms``."""

from benchmark.metrics_common import load

UNIT = "ms/step"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    return load(run, "step_forward_ms").per_step(run, "rules")
