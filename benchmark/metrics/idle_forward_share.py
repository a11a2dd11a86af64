"""Device: of the device's idle time inside the profiled batches' records
(the gaps in the union of the traced device activity, between each
record's start and end), the share during which the host was enqueueing
``decoder_forward`` (the record's ``forward`` intervals; the program
keeps intervals in a batch that starts under ``torch.profiler``). The
rest of the idle time falls in the other parts (``idle_rules_share``,
and ``stack``, ``encode``, ``prefill``, ``sync``, ``finalize``) or
between them."""

from benchmark.metrics_common import load

UNIT = "%"
MOVES = {"dictation": "latency_p50_ms", "chunks": "rtf"}


def union(kernels):
    """The union of the activities' (name, start, end) as sorted, disjoint
    [start, end]."""
    out = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy, lo, hi):
    """The stretches of [lo, hi] outside ``busy``."""
    out, t = [], lo
    for s, e in busy:
        if e <= t:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = e
    if t < hi:
        out.append((t, hi))
    return out


def overlap(a, b):
    """The length of the intersection of two sorted, disjoint lists of
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share(run, part):
    """% of the profiled batches' idle device time inside ``part``."""
    recs = load(run, "queue_wait_ms").profiled(run)
    if not recs or not run.kernels \
            or any(r.intervals is None for r in recs):
        return None
    busy = union(run.kernels)
    idle = inside = 0.0
    for r in recs:
        g = gaps(busy, r.start_ns * 1e-9, r.end_ns * 1e-9)
        idle += sum(e - s for s, e in g)
        inside += overlap(g, [(s * 1e-9, e * 1e-9)
                              for p, s, e in r.intervals if p == part])
    return 100.0 * inside / idle if idle > 0 else None


def read(run):
    return idle_share(run, "forward")
