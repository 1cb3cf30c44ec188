"""What a traced window read from ``torch.profiler``: the device's
operations and the benchmark's own host spans, in the profiler's time base
(µs), and what the readers and the breakdown take from them.

Busy time is the union of the device's activity intervals (kernels,
copies, sets), not their sum, so operations that overlap count once; the
window is the span of the benchmark's host spans, so the profiler's own
start and stop fall outside it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Tuple

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    t0: float                          # the traced window, µs
    t1: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6


def from_profiler(prof) -> Trace:
    """The device operations (user annotations left out) and the
    ``bench.*`` host spans of a stopped profiler, the device operations
    clipped to the span of the host spans."""
    from torch.autograd import DeviceType

    device, host = [], []
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == DeviceType.CUDA:
            if not getattr(evt, "is_user_annotation", False):
                device.append((evt.name, float(tr.start), float(tr.end)))
        elif evt.name.startswith(SPAN_PREFIX):
            host.append((evt.name[len(SPAN_PREFIX):], float(tr.start),
                         float(tr.end)))
    if not host:
        return Trace(0.0, 0.0)
    t0 = min(s for _, s, _ in host)
    t1 = max(e for _, _, e in host)
    device = [(n, max(s, t0), min(e, t1)) for n, s, e in device
              if e > t0 and s < t1]
    return Trace(t0, t1, sorted(device, key=lambda x: x[1]),
                 sorted(host, key=lambda x: x[1]))


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in union(
        (s, e) for _, s, e in trace.device)) * 1e-6


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return name.split("(")[0].strip()[:120]


def top_ops(trace: Trace, n: int = 10):
    """[[name, seconds]]: the n device operations that took most time."""
    tot = {}
    for name, s, e in trace.device:
        key = short_name(name)
        tot[key] = tot.get(key, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def gaps(trace: Trace):
    """[(label, seconds)] of every idle gap of the device in the window,
    each named by the host span open at its middle ("loop" when none)."""
    busy = union((s, e) for _, s, e in trace.device)
    edges = [trace.t0] + [x for iv in busy for x in iv] + [trace.t1]
    host = trace.host
    out, j = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][2] < mid:
            j += 1
        label = "loop"
        for lab, s, e in host[j:j + 4]:
            if s <= mid <= e:
                label = lab
                break
        out.append((label, (b - a) * 1e-6))
    return out


def longest_gaps(trace: Trace, n: int = 10):
    """[[label, seconds]]: the n longest idle gaps."""
    return [[lab, s] for lab, s in sorted(gaps(trace),
                                          key=lambda x: -x[1])[:n]]
