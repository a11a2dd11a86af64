"""The port's tracer: stage aggregates, the window batcher's batch
records, and the device timing helpers of the kernel scripts.

The reference has only log-line breadcrumbs with durations
(src-tauri/src/whisper.rs:75-80, audio.rs:147-153). Here:

* ``stage_timer``/``Profiler.record`` sum count, total and longest
  duration per stage name (``/stats`` shows them);
* every batch that ``pipeline/batcher.py::WindowBatcher`` runs leaves a
  :class:`BatchRecord` on ``GLOBAL_PROFILER`` (a bounded deque, in the
  order the batches end): its requests' submit stamps and preparation
  time, and its host time by part (:data:`PARTS`); ``/stats`` shows
  the recent batches' queue wait and step parts (``batch_summary``). The parts are timed
  where the work happens (``decode/greedy.py``), reaching the batch's
  record through a thread-local (each batch runs in a thread of its
  own), so no lock is taken before the batch ends. Inside a batch that
  starts while a ``torch.profiler`` session records, each part's
  intervals are kept too, so that the device trace can be read against
  them: every stamp is ``time.time_ns()``, the clock of the profiler's
  events.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter, defaultdict, deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

# A batch's host time by part, in the order the parts run: ``stack`` the
# requests' framing rows stacked and copied to the card; ``encode`` the
# mel, the encoder and the cross-KV enqueued; ``prefill`` the prompts
# padded, the cache made and the prompt's forward; ``capture`` a decode
# step captured as a CUDA graph (greedy batches on the card); then each
# decode step's ``forward`` (the ``decoder_forward`` enqueue, or the
# graph's replay, which holds the step's rules too) and ``rules`` (the
# logit rules, argmax or sampling, the step's bookkeeping, where they run
# outside a graph); ``sync`` the host blocked on the device (the exit
# check every few steps, the results' copies to the host); ``finalize``
# the results scored on the host.
PARTS = ("stack", "encode", "prefill", "capture", "forward", "rules",
         "sync", "finalize")
STEP_PARTS = ("forward", "rules", "sync", "capture")
RECORDS_KEPT = 4096         # batch records; a 51 s dictation run makes ~70
ROUTING_KEPT = 1024         # requests' routing (~30 KB each at 28 layers)
SUMMARY_BATCHES = 100       # the recent batches ``batch_summary`` reads


class StageStats:
    __slots__ = ("count", "total_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)


class BatchRecord:
    """One batch of ``WindowBatcher``: its ``requests`` (submit stamp, ns
    of preparation on the caller's thread), ``start_ns`` and ``end_ns``,
    by part (:data:`PARTS`) the summed host ``ns`` and the ``calls``, and
    ``replays``, the decode steps that ran as a replay of a CUDA graph;
    ``intervals`` holds
    each part's (part, start, end) in a batch that started while a
    ``torch.profiler`` session recorded, else None. Stamps are
    ``time.time_ns()``.

    A decode step is a pass of the greedy/sampling loop
    (``decode/greedy.py::decode_window_impl``): ``forward`` once a step
    but the last (its token needs none), ``rules`` once a step that runs
    outside a graph, ``sync`` at each exit check and once for the
    results' copies in ``decode_window_finalize`` (and for the detected
    languages' copy in an auto-language batch). On the card a greedy
    batch captures its step once (``capture``) and replays it for every
    step but the last: a replay counts under ``forward`` and in
    ``replays``, and the last step's rules run outside it. Beam search,
    speculative passes and mesh shards time no step parts: their decode
    falls outside every part (a beam batch's rows above temperature 0,
    ladder retries, sample in the greedy loop and do time them).

    ``q8_linears`` counts the decode steps' int8 linears, the logit
    projection's included, by route (``models/whisper.py::q8_route``:
    "K6", the weight dequantized on chip, or "dequant", into device
    memory), a replayed step's once a replay.

    A batch of a model with experts (``models/uni_moe.py``) keeps in
    ``experts``, for each forward (the prefill, then each decode step's)
    the real tokens it ran and, by layer, the tokens each expert took,
    the null experts included (:meth:`RoutingTrace.counts`)."""

    __slots__ = ("requests", "start_ns", "end_ns", "ns", "calls",
                 "replays", "intervals", "experts", "q8_linears")

    def __init__(self, requests: Sequence[Tuple[int, int]], start_ns: int,
                 traced: bool):
        self.requests = list(requests)
        self.start_ns = start_ns
        self.end_ns = start_ns
        self.ns = dict.fromkeys(PARTS, 0)
        self.calls = dict.fromkeys(PARTS, 0)
        self.replays = 0
        self.q8_linears: Counter = Counter()
        self.intervals: Optional[List[Tuple[str, int, int]]] = (
            [] if traced else None)
        # a model with experts: (tokens (F,), rows (F, layers, experts))
        # by forward (the prefill, then each decode step's), from
        # RoutingTrace.counts; else None
        self.experts: Optional[Tuple] = None

    def add(self, part: str, t0: int) -> int:
        """Count the time from ``t0`` to now under ``part``; return now,
        the next part's start."""
        t1 = time.time_ns()
        self.ns[part] += t1 - t0
        self.calls[part] += 1
        if self.intervals is not None:
            self.intervals.append((part, t0, t1))
        return t1

    def replayed(self, t0: int) -> int:
        """:meth:`add` for a decode step that ran as a graph's replay."""
        self.replays += 1
        return self.add("forward", t0)

    @property
    def rows(self) -> int:
        return len(self.requests)

    @property
    def steps(self) -> int:
        """Decode steps run: the ``rules`` part's calls and the replays
        (whose rules ran inside the graph)."""
        return self.calls["rules"] + self.replays

    def queue_waits_ns(self) -> List[int]:
        """Each request's wait in the queue: the batch's start minus its
        submit stamp."""
        return [self.start_ns - t for t, _ in self.requests]


class RoutingTrace:
    """A batch's routing as the window program leaves it: ``routing``
    (layers, B, T, top_k) int8 on the device, each real token's chosen
    experts at its cache column (-1 none), with the batch's ``pad_lens``
    (B,) and ``p_max``, the prompts' padded length; expert ids below
    ``n_routed`` are routed, the rest up to ``n_experts`` null. Decode
    forward k writes column ``p_max + k``."""

    def __init__(self, routing, pad_lens, p_max: int, n_routed: int,
                 n_experts: int):
        self.routing, self.pad_lens, self.p_max = routing, pad_lens, p_max
        self.n_routed, self.n_experts = n_routed, n_experts

    def row(self, host, i: int, n_served: int):
        """(layers, prompt + n_served - 1, top_k) of row i, from the host
        copy: its prompt's columns and those of the served tokens fed
        back."""
        return host[:, i, int(self.pad_lens[i]):self.p_max + n_served - 1]

    def counts(self, host):
        """(tokens (F,), rows (F, layers, experts), n_routed) for the F
        forwards that ran: the prefill's real columns, then each decode
        column written."""
        import numpy as np
        ids = host.astype(np.int64)                   # (L, B, T, K)
        n_l, n_e = ids.shape[0], self.n_experts
        n_fwd = 1 + int((ids[0, :, self.p_max:, 0] >= 0).any(0).sum())
        ids = ids[:, :, :self.p_max + n_fwd - 1]
        fwd = np.concatenate([np.zeros(self.p_max, np.int64),
                              np.arange(1, n_fwd)])    # a column's forward
        ok = ids >= 0
        key = ((fwd[None, None, :, None] * n_l
                + np.arange(n_l)[:, None, None, None]) * n_e + ids)[ok]
        rows = np.bincount(key, minlength=n_fwd * n_l * n_e).reshape(
            n_fwd, n_l, n_e)
        tokens = np.bincount(np.broadcast_to(fwd, ok.shape[1:3])[
            ok[0, :, :, 0]], minlength=n_fwd)
        return tokens, rows, self.n_routed


def expert_summary(records) -> Dict[str, float]:
    """What the records' expert counts say, over every forward and layer
    (``BatchRecord.experts``): routed rows a forward and layer, routed
    experts hit, the null's share of the slots taken, routed slots a
    token, and the busiest routed expert's rows over the mean of those
    hit. Empty without counts."""
    import numpy as np
    got = [r.experts for r in records if getattr(r, "experts", None)]
    if not got:
        return {}
    n_routed = got[0][2]
    tokens = np.concatenate([t for t, _, _ in got])
    rows = np.concatenate([r for _, r, _ in got]).astype(np.float64)
    routed = rows[..., :n_routed]                    # (F, L, R)
    hit = (routed > 0).sum(-1)
    m = routed.reshape(-1, n_routed)
    some = m.sum(1) > 0
    busy = m[some].max(1) * hit.reshape(-1)[some] / m[some].sum(1)
    return {"routed_rows": float(routed.sum(-1).mean()),
            "experts_hit": float(hit.mean()),
            "null_share": float(rows[..., n_routed:].sum()
                                / max(rows.sum(), 1.0)),
            "slots_per_token": float(routed.sum() / max(
                tokens.sum() * rows.shape[1], 1)),
            "busiest_over_mean": float(busy.mean()) if busy.size else 0.0}


class _NoRecord:
    """The record a thread that runs no batch times into: nothing."""

    __slots__ = ()
    q8_linears = None

    def add(self, part: str, t0: int) -> int:
        return t0

    def replayed(self, t0: int) -> int:
        return t0


NO_RECORD = _NoRecord()
_local = threading.local()


def batch_record():
    """The record of the batch this thread runs, else :data:`NO_RECORD`."""
    return getattr(_local, "record", NO_RECORD)


class Profiler:
    """Thread-safe stage-time aggregator, and the keeper of the window
    batcher's batch records."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = defaultdict(StageStats)
        self._batches: deque[BatchRecord] = deque(maxlen=RECORDS_KEPT)
        self._routing: deque = deque(maxlen=ROUTING_KEPT)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._stages[name].add(dt)

    def record(self, name: str, dt: float) -> None:
        """Record an externally measured duration (e.g. first-partial
        latency, whose start point lives in another thread)."""
        with self._lock:
            self._stages[name].add(dt)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                k: dict(count=v.count, total_s=v.total_s, max_s=v.max_s,
                        mean_s=v.total_s / max(v.count, 1))
                for k, v in self._stages.items()
            }

    @contextlib.contextmanager
    def batch(self, requests: Sequence[Tuple[int, int]]
              ) -> Iterator[BatchRecord]:
        """Open the record of a batch the calling thread runs; at the end
        it is published, whether or not the batch raised."""
        from torch.autograd import profiler as torch_profiler
        rec = BatchRecord(requests, time.time_ns(),
                          getattr(torch_profiler, "_is_profiler_enabled",
                                  False))
        _local.record = rec
        try:
            yield rec
        finally:
            rec.end_ns = time.time_ns()
            del _local.record
            with self._lock:
                self._batches.append(rec)

    def batch_records(self) -> List[BatchRecord]:
        """The kept batch records, in the order their batches ended."""
        with self._lock:
            return list(self._batches)

    def keep_routing(self, prompt: Sequence[int], served: Sequence[int],
                     routing) -> None:
        """Keep a request's routing ((layers, positions, top_k), the
        prompt's positions and the served tokens' fed back) beside its
        prompt and served tokens."""
        with self._lock:
            self._routing.append((tuple(prompt), tuple(served), routing))

    def routing_records(self) -> List[Tuple[tuple, tuple, object]]:
        """The kept (prompt, served, routing), oldest first."""
        with self._lock:
            return list(self._routing)

    def batch_summary(self) -> Dict[str, Dict[str, float]]:
        """The last :data:`SUMMARY_BATCHES` batches' queue wait (ms, p50
        and p95 over their rows) and host ms a decode step by step part
        (over those that ran decode steps), with ``replayed_share``, the
        share of the steps with a forward that ran it as a graph's
        replay; the decode steps' int8 linears by route
        (``q8_linears``), with ``k6_share``, K6's share of them; for a
        model with experts :func:`expert_summary`; an entry without
        samples is left out."""
        import numpy as np
        recs = self.batch_records()[-SUMMARY_BATCHES:]
        out: Dict[str, Dict[str, float]] = {}
        waits = [w for r in recs for w in r.queue_waits_ns()]
        if waits:
            p50, p95 = np.percentile(waits, [50, 95]) * 1e-6
            out["queue_wait_ms"] = {"p50": float(p50), "p95": float(p95)}
        steps = sum(r.steps for r in recs)
        if steps:
            out["step_ms"] = {p: sum(r.ns[p] for r in recs) * 1e-6 / steps
                              for p in STEP_PARTS}
            forwards = sum(r.calls["forward"] for r in recs)
            out["step_ms"]["replayed_share"] = (
                sum(r.replays for r in recs) / forwards if forwards else 0.0)
        q8 = sum((r.q8_linears for r in recs), Counter())
        if q8:
            out["q8_linears"] = dict(q8, k6_share=q8["K6"] / sum(q8.values()))
        experts = expert_summary(recs)
        if experts:
            out["experts"] = experts
        return out


GLOBAL_PROFILER = Profiler()


def stage_timer(name: str):
    return GLOBAL_PROFILER.stage(name)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Ms per call of ``fn`` between two CUDA events over ``reps`` calls
    back to back (after ``warmup`` calls): the host's per-call work paces
    it where that is longer than the device's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of one call of ``fn``: captured once in a CUDA graph
    and replayed ``reps`` times between CUDA events, so that the host's
    per-call work (Python, the ctypes call) does not pace the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps=reps, warmup=2)


def in_turns(calls: Dict[str, object], reps: int) -> Dict[str, list]:
    """{name: [ms in order, ms in reverse order]} of each call of
    ``calls`` (``cuda_ms``), timed every one in order and then in reverse
    order, so that a drift of the card's clock over the run shows."""
    times = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        times[name].append(cuda_ms(calls[name], reps))
    return times


def device_ms_split(fn, reps: int, match: str):
    """Device ms per call of ``fn`` from ``torch.profiler`` over ``reps``
    calls (the caller has warmed it up), split by kernel name: (the ms of
    the kernels whose name holds ``match``, [(name, ms) of each other
    kernel])."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(ka[0], "self_device_time_total")
            else "self_cuda_time_total")
    rows = [(e.key, getattr(e, attr) / 1e3 / reps) for e in ka
            if getattr(e, attr) > 0]
    return (sum(t for n, t in rows if match in n),
            [(n, t) for n, t in rows if match not in n])


# K1's and K12's launches by part, for ``device_ms_by_part``: (label, name
# fragments), a kernel counted under the first part one of whose fragments
# its name holds (the port's first GEMMs' names too, for a version built
# from an older csrc/); K12's LN2 is an ln_quant beside LN1
K1_PARTS = (
    ("ln_quant", ("ln_quant_kernel<__nv_bfloat16",)),
    ("q/k/v GEMM", ("proj_wgmma_kernel", "qkv_gemm_kernel")),
    ("int8_prep", ("i8_stats_kernel", "i8_quant_kv_kernel")),
    ("attention", ("attn_wgmma_kernel",)),
    ("o quant", ("ln_quant_kernel<float",)),
    ("o GEMM", ("mlp_fc2_kernel<__nv_bfloat16, true>", "fc2_gemm_kernel")),
    ("fc1", ("mlp_fc1_",)),
    ("fc2", ("mlp_fc2_kernel",)),
)


def device_ms_by_part(fn, reps: int, parts=K1_PARTS):
    """Device ms per call of ``fn`` by part (``device_ms_split`` over
    ``reps`` calls, which the caller has warmed up): [(label, ms)] in the
    order of ``parts``, then ("other NAME", ms) for a kernel no part
    names."""
    _, rows = device_ms_split(fn, reps, "\0")
    ms: Dict[str, float] = {}
    for name, t in rows:
        label = next((lab for lab, frags in parts
                      if any(f in name for f in frags)),
                     "other " + name.split("(")[0][:48])
        ms[label] = ms.get(label, 0.0) + t
    order = [lab for lab, _ in parts]
    return sorted(ms.items(), key=lambda kv: order.index(kv[0])
                  if kv[0] in order else len(order))

