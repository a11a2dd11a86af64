"""Per-stage timing and RTF counters.

The reference has only log-line breadcrumbs with durations
(src-tauri/src/whisper.rs:75-80, audio.rs:147-153); here observability is a
real subsystem since real-time factor is the benchmark metric. Stage timers
aggregate into a global registry; ``rtf()`` converts audio-seconds /
wall-seconds. ``torch.profiler`` traces can be wrapped around any stage.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator


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


class Profiler:
    """Thread-safe stage-time aggregator."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: Dict[str, StageStats] = defaultdict(StageStats)

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

    def reset(self):
        with self._lock:
            self._stages.clear()


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


def rtf(audio_seconds: float, wall_seconds: float) -> float:
    """Real-time factor: audio seconds transcribed per wall second."""
    return audio_seconds / max(wall_seconds, 1e-9)
