"""Whole step: the model's operations for the run's steady batches (in a
traced run those before the profiler's first, ``harness.Run.steady``), each at
its least time (int8 at 1,979 TOP/s, bf16 at 989 TFLOP/s: the family's
``batch_least_s``, Whisper's ``benchmark/ops/arith.py::batch_least_s``), over
the batches' summed walls."""

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def read(run):
    wall = sum(b.end - b.start for b in run.steady)
    if wall <= 0:
        return None
    family, model = run.cell.family, run.cell.model
    least = sum(family.batch_least_s(model, b.prompt_lens, b.steps)
                for b in run.steady)
    return 100.0 * least / wall
