"""Decoder loop: the share of the device's busy time in copy kernels
(PyTorch's elementwise copies: on the int8 decoder's path the per-step
dequantization of every weight to bf16, and the cache writes) in the
profiled batches. Transfers between host and card are not counted."""

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    if not run.kernels:
        return None
    busy = run.busy_s
    copy = sum(e - s for n, s, e in run.kernels
               if "copy" in n.lower() and not n.startswith("Memcpy"))
    return 100.0 * copy / busy if busy > 0 else None
