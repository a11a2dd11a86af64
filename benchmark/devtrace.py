"""The device trace of a profiled stretch, reduced to what the per-layer
readers need: every device activity (kernels, copies, sets) as (name,
start, end), the union of their intervals (busy time), the time by name,
and the idle gaps named by the activity that ends them.

``torch.profiler`` records the CUDA activity only (no host op events, so
the profiler adds little to the host-bound decode loop); the raw kineto
events are read without building the profiler's own event tree.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

Interval = Tuple[str, float, float]      # (name, start s, end s)


def init():
    """Start and stop the profiler once in the calling thread. The
    profiler's first start has to run in the thread that imported torch
    (kineto's client registers there); later starts may run in the
    batcher's threads."""
    import torch
    prof = start()
    torch.ones(1, device="cuda").add_(1)
    stop(prof)


def start():
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> List[Interval]:
    """Stop ``prof`` and return its device activities, sorted by start."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof.stop()
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        s, e = ev.start_ns(), ev.end_ns()
        if e > s:
            out.append((ev.name(), s * 1e-9, e * 1e-9))
    out.sort(key=lambda x: x[1])
    return out


def busy_and_gaps(iv: List[Interval]):
    """(busy seconds: the union of the intervals, [(gap s, name of the
    activity that ends the gap)])."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for name, s, e in iv:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def time_by_name(iv: List[Interval]) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for name, s, e in iv:
        out[name] += e - s
    return dict(out)


def short_name(name: str, n: int = 100) -> str:
    """A kernel's name without its parameters and template arguments,
    with the functor of a PyTorch elementwise kernel in brackets:
    ``at::native::unrolled_elementwise_kernel[direct_copy_kernel_cuda]``."""
    head = name.split("(")[0].split("<")[0].replace("void ", "").strip()
    inner = re.findall(r"(\w+Functor|\w+_kernel_cuda)", name[len(head):])
    if "elementwise_kernel" in head and inner:
        head += f"[{inner[-1]}]"
    return (head or name)[:n]


def breakdown(iv: List[Interval], gaps) -> Dict:
    """The ten device activities that took most time, and the ten names
    whose waits (the idle gaps they end, ``busy_and_gaps``'s) added up
    longest."""
    by = defaultdict(float)
    for name, t in time_by_name(iv).items():
        by[short_name(name)] += t
    waits = defaultdict(float)
    for g, name in gaps:
        waits["before " + short_name(name)] += g
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by), "idle_gaps": top(waits)}
