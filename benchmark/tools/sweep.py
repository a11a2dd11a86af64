"""The knee of an open-loop mix on the card: the highest offered rate the
port serves without a growing backlog.

    python3 benchmark/tools/sweep.py --workload <cell> --rates 8,10,12 \\
        --seconds 20 --seed <n>

One engine serves every rate in turn (one process, one set-up). For each
rate: the requests answered in the window, the backlog when it closed
(sent and not yet answered), the latency's median and 95th percentile
from the due time, the median of the first and of the last third of the
requests (a backlog that grows shows as the second far above the first),
and how late the generator ran. One JSON line a rate.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path[0] = ROOT

from benchmark import harness, traffic  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args()
    cell = harness.load_cell(ROOT, a.workload)
    _, vocab, enc = cell.family.vocabulary(cell.model)
    engine = cell.family.build_engine(cell, a.seed, vocab, "cuda")
    harness.warm(engine, cell, traffic.make_requests(cell.mix, a.seed, 5.0,
                                                     enc))
    for rate in (float(r) for r in a.rates.split(",")):
        cell.mix = dict(cell.mix, rate_per_s=rate)
        reqs = traffic.make_requests(cell.mix, a.seed, a.seconds, enc)
        run = harness.Run(cell=cell, seconds=a.seconds,
                          sample_len=int(cell.mix["decode"]["sample_len"]))
        srv = harness.Serving(engine, cell, run, False)
        srv.t0 = time.perf_counter()
        recs = harness.open_loop(srv, reqs, a.seconds, 128)
        srv.close()
        run.records = recs
        lat = [(r.done - r.due) * 1e3 if r.ok else float("inf")
               for r in recs]
        print(json.dumps({
            "rate": rate, "sent": len(recs),
            "answered_in_window": sum(r.ok and r.done <= a.seconds
                                      for r in recs),
            "backlog_at_close": sum(not (r.ok and r.done <= a.seconds)
                                    for r in recs),
            "p50_ms": traffic.percentile(lat, 50),
            "p95_ms": traffic.percentile(lat, 95),
            "p50_first_third_ms": traffic.percentile(
                lat[: len(lat) // 3], 50),
            "p50_last_third_ms": traffic.percentile(
                lat[-(len(lat) // 3):], 50),
            "max_late_ms": max((r.sent - r.due) * 1e3 for r in recs),
            "rows_a_batch": (sum(run.batch_sizes) / len(run.batch_sizes)
                             if run.batch_sizes else 0),
            "tokens_ok": all(len(r.served) == run.sample_len
                             for r in recs if r.ok)}), flush=True)


if __name__ == "__main__":
    main()
