"""The program's own spans in a traced window: the ``repro_torch.*`` regions
that ``repro_torch.obs.spans`` opens on the profiler's timeline while it
records, read from a ``trace.Trace``.

A program span is a CPU event of the trace named ``repro_torch.<span>``;
a span of one thread nests in the span that was open when it started.
The readers of ``metrics/`` ask here which spans were open at a moment,
which CUDA runtime calls fell inside them, and how much of the device's
idle time the host spent inside them. A trace of a program without such
spans (an older commit) lists none, and each reader then returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "repro_torch."
#: CUDA runtime calls that block the host until the device has caught up.
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
#: CUDA runtime calls that allocate or free device memory outside the
#: caching allocator's pool; cudaFree waits for the device.
ALLOCS = ("cudaMalloc", "cudaFree")

Interval = Tuple[float, float, str]


def spans(t, name: Optional[str] = None) -> List[Interval]:
    """The window's program spans as (start µs, end µs, name), by start;
    only those of ``name`` (without the prefix) when given."""
    want = None if name is None else PREFIX + name
    return [(t0, t1, n) for t0, t1, n, _ in t.cpu
            if n.startswith(PREFIX) and (want is None or n == want)]


def calls(t, names: Iterable[str]) -> List[Interval]:
    """The window's CPU events (CUDA runtime calls, operators) of the
    given names, by start."""
    names = set(names)
    return [(t0, t1, n) for t0, t1, n, _ in t.cpu if n in names]


class Cover:
    """The union of some intervals: does it hold a moment?"""

    def __init__(self, intervals: Iterable[Interval]):
        merged: List[List[float]] = []
        for t0, t1, _ in sorted(intervals):
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        self._starts = [m[0] for m in merged]
        self._ends = [m[1] for m in merged]

    def __bool__(self) -> bool:
        return bool(self._starts)

    def holds(self, x: float) -> bool:
        j = bisect.bisect_right(self._starts, x) - 1
        return j >= 0 and x <= self._ends[j]


def innermost(intervals: List[Interval], moments: List[float]
              ) -> List[str]:
    """For each moment (in increasing order), the name of the innermost
    of the nested ``intervals`` (by start) open at it, or ""."""
    out, stack, i = [], [], 0
    for x in moments:
        while i < len(intervals) and intervals[i][0] <= x:
            while stack and stack[-1][1] < intervals[i][0]:
                stack.pop()
            stack.append(intervals[i])
            i += 1
        while stack and stack[-1][1] < x:
            stack.pop()
        out.append(stack[-1][2] if stack else "")
    return out


def idle_gaps(t) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window, in µs."""
    out, edge = [], t.start
    for a, b in t.busy_intervals() + [(t.end, t.end)]:
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    return out


def idle_in_spans_s(t) -> Optional[float]:
    """Seconds of the device's idle time whose middle the host spent
    inside a program span; None without program spans."""
    cover = Cover(spans(t))
    if not cover:
        return None
    return sum(b - a for a, b in idle_gaps(t)
               if cover.holds(0.5 * (a + b))) / 1e6


def count_inside(t, names: Iterable[str], span: Optional[str] = None
                 ) -> Optional[int]:
    """How many CPU events of ``names`` started inside program spans (of
    ``span`` only, when given); None without such spans."""
    cover = Cover(spans(t, span))
    if not cover:
        return None
    return sum(cover.holds(t0) for t0, _, _ in calls(t, names))


def seconds_inside(t, names: Iterable[str], span: Optional[str] = None
                   ) -> Optional[float]:
    """Host seconds in CPU events of ``names`` that started inside program
    spans (of ``span`` only, when given); None without such spans."""
    cover = Cover(spans(t, span))
    if not cover:
        return None
    return sum(t1 - t0 for t0, t1, _ in calls(t, names)
               if cover.holds(t0)) / 1e6


def idle_labels(t, n: Optional[int] = 12) -> List[list]:
    """The device's idle time summed by what the host was doing at the
    middle of each gap, as ``bench span / program span / operation``: the
    innermost of each open there ("-" where none is); the ``n`` largest
    (all for None)."""
    gaps = idle_gaps(t)
    mids = [0.5 * (a + b) for a, b in gaps]
    bench = [(t0, t1, m) for t0, t1, m, _ in t.cpu
             if m.startswith("bench.")]
    ops = [(t0, t1, m) for t0, t1, m, _ in t.cpu
           if not m.startswith(("bench.", PREFIX))]
    by: Dict[str, float] = {}
    for (a, b), s, p, o in zip(gaps, innermost(bench, mids),
                               innermost(spans(t), mids),
                               innermost(ops, mids)):
        label = f"{s or '-'} / {p or '-'} / {o or '-'}"
        by[label] = by.get(label, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
            [:n]]


def calls_by_span(t, names: Iterable[str]) -> List[list]:
    """The CPU events of ``names`` in the window, counted and their host
    seconds summed by the innermost program span open at their start
    ("-" outside every span), by seconds."""
    found = calls(t, names)
    by: Dict[str, list] = {}
    for (t0, t1, _), p in zip(found, innermost(spans(t),
                                               [c[0] for c in found])):
        row = by.setdefault(p or "-", [p or "-", 0, 0.0])
        row[1] += 1
        row[2] += (t1 - t0) / 1e6
    return sorted(by.values(), key=lambda r: -r[2])


def span_table(t) -> List[list]:
    """Each program span's name, count, host seconds and the device
    seconds of the kernels launched under it (0 where the trace has no
    device), by host seconds."""
    rows: Dict[str, list] = {}
    for _, _, name, e in t.cpu:
        if not name.startswith(PREFIX):
            continue
        row = rows.setdefault(name, [name, 0, 0.0, 0.0])
        row[1] += 1
        row[2] += (e.time_range.end - e.time_range.start) / 1e6
    for name, row in rows.items():
        row[3] = t.op_device_seconds(name)
    return sorted(rows.values(), key=lambda r: -r[2])
