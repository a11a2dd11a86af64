"""What several metric readers share: loading another metric's file, and
the encoder blocks' roofline shares."""

from __future__ import annotations

from benchmark.ops.arith import attention_block, bound_s, mlp_block

LN_QUANT = "ln_quant_kernel"


def load(run, name: str):
    from benchmark.harness import reader
    return reader(run.cell.bench_dir, name)


def block_times(run):
    """Device seconds of the attention block's and the MLP's kernels in
    the profiled span; a LayerNorm-and-quantize launch goes to the block
    whose kernel follows it."""
    attn = load(run, "attn_roofline").KERNELS
    mlp = load(run, "mlp_roofline").KERNELS
    t = {"attention": 0.0, "mlp": 0.0}
    pending = 0.0
    for name, s, e in run.kernels:
        if LN_QUANT in name:
            pending += e - s
        elif any(k in name for k in attn):
            t["attention"] += e - s + pending
            pending = 0.0
        elif any(k in name for k in mlp):
            t["mlp"] += e - s + pending
            pending = 0.0
    return t


def block_share(run, which: str):
    """The block's least time over its kernels' time, in %; None where
    the cell's family has no K1/K2 encoder blocks."""
    blocks = run.cell.family.encoder_blocks(run.cell.model)
    if blocks is None or not run.kernels or not run.profiled:
        return None
    took = block_times(run)[which]
    if took <= 0:
        return None
    d, f, n = blocks
    least = 0.0
    for b in run.profiled:
        if which == "attention":
            i8, bf, nbytes = attention_block(b.rows, 1500, d)
            least += n * bound_s(nbytes, i8, bf)
        else:
            ops, nbytes = mlp_block(b.rows, 1500, d, f)
            least += n * bound_s(nbytes, ops)
    return 100.0 * least / took
