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


def rtf(audio_seconds: float, wall_seconds: float) -> float:
    """Real-time factor: audio seconds transcribed per wall second."""
    return audio_seconds / max(wall_seconds, 1e-9)
