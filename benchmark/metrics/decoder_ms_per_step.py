"""Decoder loop (``decode/greedy.py::decode_window_impl``,
``models/whisper.py::decoder_forward``): the device time of every
activity but the encoder's kernels in the profiled batches (the decoder,
and the mel and stem's library kernels), over their decode steps."""

from benchmark.metrics_common import load

UNIT = "ms/step"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    steps = sum(b.steps for b in run.profiled)
    if not run.kernels or not steps:
        return None
    enc = load(run, "encoder_ms_per_window").encoder_s(run.kernels)
    total = sum(e - s for _, s, e in run.kernels)
    return (total - enc) * 1e3 / steps
