"""Set-up time: from the process's start to the first request of the
window (loading, weights made on the card, quantization, the warm
batches; the first run in a checkout also builds the kernels)."""

UNIT = "s"


def read(run):
    return run.setup_s
