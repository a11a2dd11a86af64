"""The readings a cell's correctness limit is set from, on the card.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--control]

For each seed, in one process: the whole run of the cell (weights, warm
batches, a window of ``--seconds`` at the cell's own load) and the
comparison with the plain reference; with ``--control`` also the control's
reading (the reference with int4 weights in the program's place, judged
on the same requests). One JSON line a seed.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args()
    cell = harness.load_cell(ROOT, a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        out = harness.execute(cell, seed, a.seconds, False, t,
                              control_bits=4 if a.control else None)
        d = out["detail"]
        print(json.dumps({
            "workload": a.workload, "seed": seed, "correct": out["correct"],
            "widest_gap": d["widest_gap"],
            "control_widest_gap": d.get("control_widest_gap"),
            "row_gaps": [float(g) for g in d["row_gaps"]],
            "tokens_judged": d["tokens_judged"],
            "answered": sum(r.ok for r in out["run"].records),
            "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
