"""Kernels: the encoder's attention block (K1,
``csrc/encoder_attention.cu``) against its roofline: the least time, at
the published H100 peaks, of the block's work in the profiled batches
(LayerNorm, the int8 q/k/v projections, scores and their product with v,
at the batch's windows of 1500 positions, counted from shapes:
``benchmark/ops/arith.py::attention_block``), over the device time of the
kernels below. A LayerNorm-and-quantize launch is the block's whose
kernel follows it."""

from benchmark.metrics_common import block_share

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}
KERNELS = ("proj_wgmma_kernel", "attn_wgmma_kernel")


def read(run):
    return block_share(run, "attention")
