"""Encoder (``models/whisper.py::_encode``, ``ops/encoder_attention.py``,
``ops/fused_mlp.py``): device time of the encoder's hand-written kernels
in the profiled batches, over the windows they encoded. The name list is
a frozen copy of ``chip_smoke.py::ENCODER_CSRC_KERNELS``."""

UNIT = "ms/window"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}
ENCODER_KERNELS = (
    "attn_wgmma_kernel", "ln_quant_kernel", "mlp_fc1_", "mlp_fc2_kernel",
    "requant_kernel", "i8_stats_kernel", "i8_quant_kv_kernel",
    "stem_mel_rows_kernel", "stem_conv_kernel", "proj_wgmma_kernel")


def encoder_s(kernels):
    return sum(e - s for n, s, e in kernels
               if any(k in n for k in ENCODER_KERNELS))


def read(run):
    windows = sum(b.rows for b in run.profiled)
    if not run.kernels or not windows:
        return None
    return encoder_s(run.kernels) * 1e3 / windows
