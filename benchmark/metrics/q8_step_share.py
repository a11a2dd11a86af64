"""Decoder loop (``models/whisper.py::decoder_forward``): the share of the
decode steps' int8 linears, the logit projection's included, that ran on
K6 (each weight tile dequantized on chip) rather than dequantized into
device memory, from the program's batch records
(``BatchRecord.q8_linears``, a replayed step's counted once a replay),
over the steady batches. A program whose records count no routes reads
None, as does a model with no int8 decoder weights."""

from benchmark.metrics_common import load

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    recs = load(run, "queue_wait_ms").steady(run)
    if not recs or not all(hasattr(r, "q8_linears") for r in recs):
        return None
    k6 = sum(r.q8_linears.get("K6", 0) for r in recs)
    total = sum(sum(r.q8_linears.values()) for r in recs)
    return 100.0 * k6 / total if total else None
