"""Kernels: the encoder's int8 MLP (K2, ``csrc/fused_mlp.cu``) against its
roofline: the least time, at the published H100 peaks, of the MLP's work
in the profiled batches (LayerNorm, fc1, GELU, fc2 at the batch's windows
of 1500 positions, counted from shapes:
``benchmark/ops/arith.py::mlp_block``), over the device time of the
kernels below. A LayerNorm-and-quantize launch is the MLP's when an MLP
kernel follows it."""

from benchmark.metrics_common import block_share

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}
KERNELS = ("mlp_fc1_", "mlp_fc2_kernel", "requant_kernel")


def read(run):
    return block_share(run, "mlp")
