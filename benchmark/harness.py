"""One run of one benchmark cell: set-up, the measured window, the trace,
the check of the served tokens against the plain reference, the result.

Everything that belongs to one configuration, traffic mix, metric or cell
is found by name (``BENCHMARK.json`` names them):

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the model
  file and its ``serving`` settings;
* ``traffic/<mix>.json``: the mix's parameters, read by ``traffic.py``;
* ``metrics/<metric>.py`` (or ``metrics/<name before the first dot>.py``):
  the metric's reader, ``read(run) -> float | None``;
* ``limits/<cell>.json``: the limits of the cell's correctness check;
* ``families/<family>.py``: the model family, which the configuration
  names with ``"family"`` (none: ``whisper``). It gives, each for a model
  file and a seed, never for a weight tree handed in:

  - ``vocabulary(model) -> (layout, vocab, encoder)``: the special-token
    layout, the vocabulary the program is served with, the plain prompt
    encoder;
  - ``build_engine(cell, seed, vocab, device)``: the program's engine on
    weights made on the card from ``seed``;
  - ``judge(cell, sample, seed, device, control_bits=None) -> dict``: the
    sample's served tokens against the family's plain reference, on
    weights it makes again from ``seed`` (``widest_gap``,
    ``tokens_judged``, ``prompts_differ``, ``row_gaps``; with a control
    ``control_widest_gap``);
  - ``batch_least_s(model, prompt_lens, steps)``: a batch's least time;
  - ``encoder_blocks(model) -> (d, ffn, layers) | None``: the K1/K2
    encoder blocks the rooflines count, None without them.

The program under test is ``nobs_whisper_torch``: whatever the family,
its engine serves every request through ``BatchedEngine.transcribe``, the
main serving path. The benchmark records its own spans around the
batcher's batches and reads the batcher's counters.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from . import guard, traffic

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
DRAIN_S = 90.0          # how long past the window's close answers are awaited
WARM_SAMPLE_LEN = 4


# ------------------------------------------------------------- cells ---

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    model: dict                 # the configuration file
    mix: dict                   # the traffic file
    limits: dict                # limits/<cell>.json
    metrics: List[dict]         # BENCHMARK.json entries this cell reports
    bench_dir: str
    family: Any = None          # families/<family>.py

    def serving(self) -> dict:
        """The configuration's serving settings, the mix's ``batcher``
        entries taking precedence."""
        return {**self.model["serving"], **self.mix.get("batcher", {})}


def _json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(root: str, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    metrics = [m for m in bench["end_to_end"] + bench["per_layer"]
               if workload in m.get("workloads", [workload])]
    for m in metrics:
        m["kind"] = "end_to_end" if m in bench["end_to_end"] else "per_layer"
    model = _json(os.path.join(root, conf["file"]))
    return Cell(
        name=workload, chips=int(w["chips"]), model=model,
        mix=_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(bench_dir, "limits", workload + ".json")),
        metrics=metrics, bench_dir=bench_dir,
        family=family(bench_dir, model.get("family", "whisper")))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(bench_dir: str, name: str):
    """The reader module of metric ``name``: ``metrics/<name>.py``, else
    ``metrics/<name before the first dot>.py``."""
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(bench_dir, "metrics", stem + ".py")
        if os.path.exists(path):
            return _module(path, f"benchmark_metric_{stem.replace('.', '_')}")
    raise FileNotFoundError(f"no reader for metric {name!r} under "
                            f"{bench_dir}/metrics")


def family(bench_dir: str, name: str):
    """The module of model family ``name``: ``families/<name>.py``."""
    path = os.path.join(bench_dir, "families", name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no module for model family {name!r}: "
                                f"{path} not found")
    return _module(path, "benchmark_family_" + name.replace(".", "_")
                   .replace("-", "_"))


# --------------------------------------------------------------- run ---

@dataclasses.dataclass
class Sent:
    """One request as sent: its due time (open loop), when it was sent
    and answered (host clock, s from the window's start), its outcome."""
    req: traffic.Request
    due: float
    sent: float = math.nan
    done: float = math.nan
    served: Optional[List[int]] = None
    prompt: Optional[List[int]] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.served is not None and self.error is None


@dataclasses.dataclass
class Batch:
    """A span the benchmark records around one batch the batcher runs
    (it ends with the results on the host, a sync)."""
    start: float
    end: float
    rows: int
    prompt_lens: List[int]
    steps: int
    profiled: bool = False


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    seconds: float
    setup_s: float = math.nan
    records: List[Sent] = dataclasses.field(default_factory=list)
    batches: List[Batch] = dataclasses.field(default_factory=list)
    kernels: Optional[list] = None      # devtrace intervals, profiled batches
    span_s: float = 0.0                 # the profiled batches' summed walls
    busy_s: float = 0.0                 # their device busy time, summed
    gaps: List[tuple] = dataclasses.field(default_factory=list)
    open_loop: bool = True
    sample_len: int = 0
    card: Optional[str] = None
    batch_sizes: List[int] = dataclasses.field(default_factory=list)

    @property
    def profiled(self) -> List[Batch]:
        return [b for b in self.batches if b.profiled]

    @property
    def steady_records(self) -> List[Sent]:
        """The requests due before the profiler's first batch (all of
        them in an untraced run)."""
        first = next((b.start for b in self.batches if b.profiled), None)
        if first is None:
            return self.records
        return [r for r in self.records if not r.due >= first]

    @property
    def steady(self) -> List[Batch]:
        """The batches the host clock reads: in a traced run those before
        the first profiled one, else all."""
        first = next((i for i, b in enumerate(self.batches) if b.profiled),
                     len(self.batches))
        return self.batches[:first]


def decode_options(mix: dict):
    from nobs_whisper_torch.decode.rules import DecodeOptions
    return DecodeOptions(**mix["decode"])


def warm(engine, cell: Cell, reqs: List[traffic.Request]):
    """One batch of each size the cell's traffic makes (an open loop: 1 to
    ``max_batch`` rows; a closed loop: its clients), with a short
    sample_len, through a BatchedEngine of their own over ``engine``: the
    kernels load, the encoder's K-major weight copies are made, the
    allocator and the libraries meet the cell's sizes."""
    from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
    opts = dataclasses.replace(decode_options(cell.mix),
                               sample_len=WARM_SAMPLE_LEN)
    rows = int(cell.serving()["max_batch"])
    sizes = (range(rows, 0, -1) if cell.mix["kind"] == "open_poisson"
             else [int(cell.mix["clients"])])
    longest = sorted(reqs, key=lambda r: -r.length)
    for n in sizes:
        be = BatchedEngine(engine, opts=opts, max_batch=n, max_wait_ms=5000.0)
        try:
            with ThreadPoolExecutor(n) as ex:
                list(ex.map(lambda r: be.transcribe(
                    r.audio, language="en", vocabulary=r.vocabulary,
                    context=r.context),
                    [longest[i % len(longest)] for i in range(n)]))
        finally:
            be.close()


class Serving:
    """The BatchedEngine of the window, with the benchmark's spans around
    its batches and the capture of each request's window results."""

    def __init__(self, engine, cell: Cell, run: Run, trace: bool):
        from nobs_whisper_torch.pipeline.batched_engine import BatchedEngine
        s = cell.serving()
        self.be = BatchedEngine(engine, opts=decode_options(cell.mix),
                                max_batch=int(s["max_batch"]),
                                max_wait_ms=float(s["max_wait_ms"]))
        self.run, self.trace = run, trace
        self.t0 = time.perf_counter()       # the window's start, set again
        prof = cell.mix.get("profile", {})
        self.after_s = float(prof.get("after_frac", 0.5)) * run.seconds
        self.min_s = float(prof.get("min_s", 1.0))
        self.local = threading.local()
        b = self.be.batcher
        self._run_batch, self._submit = b._run_batch, b.submit
        b._run_batch, b.submit = self._spanned, self._captured

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def _captured(self, mel, prompt, **kw):
        fut = self._submit(mel, prompt, **kw)
        cap = getattr(self.local, "cap", None)
        if cap is not None:
            cap.append((list(prompt), fut))
        return fut

    def _spanned(self, batch):
        """The benchmark's span around one batch. In a traced run the
        batches from the first that starts ``after_s`` into the window on
        are profiled, each on its own (the batcher runs every batch in a
        thread of its own, and a profiler stops in the thread that started
        it), until their walls add up to ``min_s``. ``after_s`` is the
        mix's ``after_frac`` of the window: the batches before it are the
        steady part that the profiler's stops (seconds each, between
        batches) have not disturbed."""
        from . import devtrace
        run = self.run
        prof = None
        if (self.trace and run.span_s < self.min_s
                and (run.kernels is not None or self.now() >= self.after_s)):
            prof = devtrace.start()
            run.kernels = run.kernels or []
        start = self.now()
        try:
            self._run_batch(batch)
        finally:
            end = self.now()
            run.batches.append(Batch(
                start=start, end=end, rows=len(batch),
                prompt_lens=[len(r.prompt) for r in batch],
                steps=run.sample_len, profiled=prof is not None))
            if prof is not None:
                iv = devtrace.stop(prof)
                busy, gaps = devtrace.busy_and_gaps(iv)
                run.kernels.extend(iv)
                run.busy_s += busy
                run.gaps.extend(gaps)
                run.span_s += end - start

    def serve(self, rec: Sent):
        """Send one request and wait for its answer."""
        r = rec.req
        self.local.cap = []
        rec.sent = self.now()
        try:
            self.be.transcribe(r.audio, language="en",
                               vocabulary=r.vocabulary, context=r.context)
            prompt, fut = self.local.cap[-1]
            rec.served, rec.prompt = list(fut.result().tokens), prompt
        except Exception as e:              # a failed request is counted
            rec.error = repr(e)
        rec.done = self.now()
        self.local.cap = None

    def close(self):
        self.run.batch_sizes = list(self.be.batcher.batch_sizes)
        self.be.close()


def open_loop(srv: Serving, reqs: List[traffic.Request], seconds: float,
              workers: int) -> List[Sent]:
    """Send each request at its due time, whatever the system is doing;
    wait for every answer up to ``DRAIN_S`` past the window's close."""
    recs = [Sent(req=r, due=r.due_s) for r in reqs]
    ex = ThreadPoolExecutor(workers)
    futs = []
    for rec in recs:
        wait = rec.due - srv.now()
        if wait > 0:
            time.sleep(wait)
        futs.append(ex.submit(srv.serve, rec))
    deadline = time.perf_counter() + max(0.0, seconds - srv.now()) + DRAIN_S
    for f in futs:
        try:
            f.result(timeout=max(0.0, deadline - time.perf_counter()))
        except TimeoutError:
            pass
    ex.shutdown(wait=False, cancel_futures=True)
    for rec in recs:
        if rec.served is None and rec.error is None:
            rec.error = "no answer within the drain"
    return recs


def closed_loop(srv: Serving, pool: List[traffic.Request], seconds: float,
                clients: int) -> List[Sent]:
    """``clients`` clients, each sending its next request when its last
    returns, until the window closes; the requests in flight finish."""
    recs: List[List[Sent]] = [[] for _ in range(clients)]

    def client(c: int):
        k = 0
        while srv.now() < seconds:
            rec = Sent(req=pool[(c + clients * k) % len(pool)], due=math.nan)
            recs[c].append(rec)
            srv.serve(rec)
            k += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + DRAIN_S)
    out = [r for rs in recs for r in rs]
    for rec in out:
        if rec.served is None and rec.error is None:
            rec.error = "no answer within the drain"
    return out


def sample_for_check(recs: List[Sent], n: int, seed: int) -> List[Sent]:
    """``n`` answered requests drawn from the seed, the one with the
    longest audio and the one with the longest prompt among them."""
    ok = [r for r in recs if r.ok]
    if not ok:
        return []
    rng = np.random.default_rng(seed + 1)
    pick = {max(range(len(ok)), key=lambda i: ok[i].req.length),
            max(range(len(ok)), key=lambda i: len(ok[i].prompt))}
    rest = [i for i in rng.permutation(len(ok)) if i not in pick]
    pick.update(rest[: max(0, n - len(pick))])
    return [ok[i] for i in sorted(pick)]


def check(cell: Cell, run: Run, seed: int, device,
          control_bits: Optional[int] = None) -> Dict:
    """The correctness numbers: each with its value and limit."""
    recs = run.records
    short = sum(1 for r in recs if r.ok and len(r.served) != run.sample_len)
    failed = sum(1 for r in recs if not r.ok)
    sample = sample_for_check(recs, int(cell.mix["check"]["requests"]), seed)
    got = cell.family.judge(
        cell, [dict(audio=s.req.audio, vocabulary=s.req.vocabulary,
                    context=s.req.context, prompt=s.prompt,
                    served=s.served) for s in sample],
        seed, device, control_bits=control_bits)
    checks = {
        "widest_gap": {"value": got["widest_gap"],
                       "limit": cell.limits["widest_gap"]},
        "tokens_judged": {"value": got["tokens_judged"],
                          "limit": cell.limits["tokens_judged_min"]},
        "prompts_differ": {"value": got["prompts_differ"], "limit": 0},
        "rows_not_sample_len": {"value": short, "limit": 0},
        "failed": {"value": failed, "limit": 0},
    }
    correct = (got["widest_gap"] <= cell.limits["widest_gap"]
               and got["tokens_judged"] >= cell.limits["tokens_judged_min"]
               and got["prompts_differ"] == 0 and short == 0
               and failed == 0)
    return {"correct": bool(correct), "checks": checks, "detail": got}


def log(t_start: float, what: str):
    print(f"[{time.perf_counter() - t_start:8.3f} s] {what}", file=sys.stderr,
          flush=True)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
            device="cuda", control_bits: Optional[int] = None) -> Dict:
    """Set up, run the window, free the program, check; the result's
    fields. ``t_start``: the process's start on the host clock."""
    import torch
    log(t_start, "torch imported")
    _, vocab, enc = cell.family.vocabulary(cell.model)
    mix = cell.mix
    reqs = traffic.make_requests(mix, seed, seconds, enc)
    log(t_start, f"{len(reqs)} requests made")
    run = Run(cell=cell, seconds=seconds,
              open_loop=mix["kind"] == "open_poisson",
              sample_len=int(mix["decode"]["sample_len"]))
    engine = cell.family.build_engine(cell, seed, vocab, device)
    if device != "cpu":
        torch.cuda.synchronize()
    log(t_start, "weights made and quantized")
    warm(engine, cell, reqs)
    log(t_start, "warm batches done")
    if trace:
        from . import devtrace
        devtrace.init()
    srv = Serving(engine, cell, run, trace)
    if device != "cpu":
        torch.cuda.synchronize()
        run.card = torch.cuda.get_device_name(0)
    srv.t0 = time.perf_counter()
    run.setup_s = srv.t0 - t_start
    try:
        if run.open_loop:
            run.records = open_loop(srv, reqs, seconds,
                                    int(mix.get("workers", 128)))
        else:
            run.records = closed_loop(srv, reqs, seconds, int(mix["clients"]))
    finally:
        srv.close()
    log(t_start, f"window closed, {len(run.records)} requests answered or "
        "failed; batches (start s, wall s, rows): " + " ".join(
            f"{b.start:.2f},{b.end - b.start:.3f},{b.rows}"
            for b in run.batches))
    peak = torch.cuda.max_memory_allocated(0) if device != "cpu" else 0
    del srv, engine
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    verdict = check(cell, run, seed, device, control_bits)
    log(t_start, "reference check done")
    return {"run": run, "peak": peak, **verdict}


def metrics_of(cell: Cell, run: Run, kind: str) -> Dict:
    out = {}
    for m in cell.metrics:
        if m["kind"] != kind:
            continue
        v = reader(cell.bench_dir, m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    a.seed %= 2 ** 63           # any whole number; the generators take these
    root = os.path.dirname(BENCH_DIR)
    bad = guard.scan(BENCH_DIR)
    if bad:
        print("forbidden imports in the harness:\n" + "\n".join(bad),
              file=sys.stderr)
        return 3
    cell = load_cell(root, a.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = execute(cell, a.seed, a.seconds, bool(a.trace), t_start)
    run = out["run"]
    found = guard.loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    from . import devtrace as tr
    device = {"platform": "gpu", "kind": run.card, "count": cell.chips,
              "memory_peak_bytes": int(out["peak"])}
    line = {"correct": out["correct"],
            "attempted": len(run.records),
            "failed": sum(1 for r in run.records if not r.ok),
            "metrics": metrics_of(cell, run,
                                  "per_layer" if a.trace else "end_to_end"),
            "device": device}
    if a.trace:
        if not run.kernels:
            print("the trace holds no device activity", file=sys.stderr)
            return 4
        device.update(busy_s=run.busy_s, window_s=run.span_s)
        line["breakdown"] = tr.breakdown(run.kernels, run.gaps)
    line["checks"] = out["checks"]
    print(json.dumps(out["detail"] | {"card": run.card,
                                      "power_limit_w": power_limit()}),
          file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def power_limit() -> Optional[str]:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except Exception:
        return None
