"""The host cost of the window batcher's batch record
(``nobs_whisper_torch/utils/profiling.py``) a decode step.

An eager decode step of ``decode/greedy.py::decode_window_impl`` stamps
two parts (``rules``, ``forward``; a step replayed from a CUDA graph one)
and every eighth step a third (``sync``). This times the eager pattern of
stamps alone: on no record (``NO_RECORD``, a
thread that runs no batch), on a record, and on a record that keeps its
intervals (a batch under ``torch.profiler``), each against the same loop
without stamps, in turns; and a batch's record opened and published
(once a batch). Prints ns a step, best of the turns.

    python3 scripts/torch_trace_cost.py [--steps 200000] [--turns 5]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from nobs_whisper_torch.utils.profiling import (  # noqa: E402
    NO_RECORD, BatchRecord, Profiler)


def stamped(rec, steps: int) -> float:
    t = time.time_ns()
    t0 = time.perf_counter_ns()
    for step in range(steps):
        if step and step % 8 == 0:
            t = rec.add("sync", t)
        t = rec.add("rules", t)
        t = rec.add("forward", t)
    return (time.perf_counter_ns() - t0) / steps


def bare(steps: int) -> float:
    t0 = time.perf_counter_ns()
    for step in range(steps):
        if step and step % 8 == 0:
            pass
    return (time.perf_counter_ns() - t0) / steps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200_000)
    ap.add_argument("--turns", type=int, default=5)
    a = ap.parse_args(argv)
    kinds = {
        "no record": lambda: NO_RECORD,
        "record": lambda: BatchRecord([(0, 0)] * 16, 0, False),
        "record + intervals": lambda: BatchRecord([(0, 0)] * 16, 0, True),
    }
    best = {k: float("inf") for k in kinds}
    for _ in range(a.turns):
        for k, make in kinds.items():
            best[k] = min(best[k], stamped(make(), a.steps) - bare(a.steps))
    prof, n = Profiler(), 2000
    with prof.batch([]):            # the first imports torch's profiler
        pass
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with prof.batch([(0, 0)] * 16) as rec:
            rec.add("stack", rec.start_ns)
    per_batch = (time.perf_counter_ns() - t0) / n
    for k, v in best.items():
        print(f"[trace-cost] {k}: {v:.0f} ns a step")
    print(f"[trace-cost] a 16-row batch's record opened and published: "
          f"{per_batch:.0f} ns ({per_batch / 48:.0f} ns a step over 48 "
          f"steps)")


if __name__ == "__main__":
    main()
