"""Experts (``ops/moe.py``): the device time of the expert kernels (every
activity whose name starts with ``moe_``) in the profiled batches, over
their decode steps. A program without them reads None."""

UNIT = "ms/step"
MOVES = {"chunks": "rtf"}
PREFIX = "moe_"


def moe_s(kernels):
    return sum(e - s for n, s, e in kernels if n.startswith(PREFIX))


def read(run):
    steps = sum(b.steps for b in run.profiled)
    if not run.kernels or not steps:
        return None
    took = moe_s(run.kernels)
    return took * 1e3 / steps if took > 0 else None
