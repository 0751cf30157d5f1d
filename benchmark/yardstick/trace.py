"""A profiled stretch of a run and its reduction: the device's busy time,
the device operations that took the most time, and the idle gaps labelled
with what the host was doing.

`profiled(fn)` runs `fn` under `torch.profiler` with host and device
activity, inside a `bench.stretch` range whose host interval is the traced
window. Device intervals (kernels, copies, sets) come from the profiler's
device events; their union within the window is the busy time.
"""

from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

STRETCH = "bench.stretch"
TOP = 10


@dataclass
class Trace:
    window_s: float                               # the stretch's host range
    busy_s: float                                 # union of device intervals
    kernels: List[Tuple[str, float, float]]      # (name, start_us, end_us)
    device_ops: List[list] = field(default_factory=list)
    idle_gaps: List[list] = field(default_factory=list)

    def device_ms(self, *needles: str) -> Tuple[float, int]:
        """Device ms and count of the kernels whose name holds any needle."""
        hits = [e - s for n, s, e in self.kernels if any(k in n for k in needles)]
        return sum(hits) / 1e3, len(hits)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host_events):
    """Each gap's seconds under the name of the innermost host event that
    spans its midpoint (the latest-started one still running), summed by
    name; "host" where none does."""
    host_events = sorted(host_events, key=lambda x: x[1])
    starts = [s for _, s, _ in host_events]
    totals: Dict[str, float] = {}
    heap: list = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        j = bisect.bisect_right(starts, mid)
        while i < j:
            name, s, e = host_events[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        label = heap[0][2] if heap else "host"
        totals[label] = totals.get(label, 0.0) + (g1 - g0) / 1e6
    return sorted(([k, v] for k, v in totals.items()), key=lambda kv: -kv[1])


def reduce(prof) -> Trace:
    """The stretch's device activity from a finished profiler."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    window = [e for e in events if e.name == STRETCH
              and e.device_type == DeviceType.CPU]
    if not window:
        raise RuntimeError("the profiled stretch has no bench.stretch range")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    kernels, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name == STRETCH or getattr(e, "is_user_annotation", False):
                continue        # a host range's mirror on the device
            s, t = max(s, w0), min(t, w1)
            if t > s:
                kernels.append((e.name, s, t))
        elif e.name != STRETCH and t > w0 and s < w1:
            host.append((e.name, s, t))
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device activity")
    merged = _union((s, t) for _, s, t in kernels)
    busy_us = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    by_name: Dict[str, float] = {}
    for n, s, t in kernels:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    ops = sorted(([n[:160], v] for n, v in by_name.items()),
                 key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                 kernels=kernels, device_ops=ops,
                 idle_gaps=[[n[:160], v] for n, v in
                            _label_gaps(gaps, host)[:TOP]])


def profiled(fn) -> Trace:
    """Run `fn()` (which ends with the device synchronised) under the
    profiler and reduce its stretch."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(STRETCH):
            fn()
            torch.cuda.synchronize()
    return reduce(prof)
