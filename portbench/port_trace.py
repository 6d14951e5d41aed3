"""The port's own spans in a torch.profiler trace of the measured window.

The port places spans named "nfl.<layer>" at its layer boundaries
(nfllib_tpu_torch/profiling.py, `span`: host events of category "cpu_op")
whenever a profiler session records.  From the same Chrome trace events as trace.Summary,
this module takes the device's idle time inside the window (no kernel,
copy or fill running, as Summary counts busy time) and splits it by the
innermost nfl.* span open on the host at each instant: idle time that
the port's host path accounts for, and idle time outside the port (the
harness, the wake-up from synchronisation, Python between calls).  A
trace of a port without spans holds none, and `spans` is then 0.

run.py does not call it: a traced run's Window keeps the Summary of the
profiler's events and not the events, which this module reads.
"""
from __future__ import annotations

import collections
import heapq

from .trace import DEVICE_CATS

PREFIX = "nfl."
SPAN_CAT = "cpu_op"
REQUEST = "portbench.request"


def idle_intervals(xs, w0: float, w1: float) -> list:
    """[a, b) stretches of [w0, w1) in which no device operation ran: the
    complement of the union of the kernels, copies and fills that start
    inside the window (clipped to it), as Summary counts busy time."""
    ivs = sorted((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]), w1))
                 for e in xs if e.get("cat") in DEVICE_CATS
                 and w0 <= float(e["ts"]) < w1)
    idle, prev = [], w0
    for a, b in ivs + [(w1, w1)]:
        if a > prev:
            idle.append((prev, a))
        prev = max(prev, b)
    return idle


def innermost(spans) -> list:
    """Disjoint (a, b, name) stretches covering the union of the spans
    (a, b, name), each named after the innermost span open over it: the
    open span that started last (of two that started together, the one
    that ends first)."""
    spans = sorted(spans)
    times = sorted({t for a, b, _ in spans for t in (a, b)})
    heap, out, i = [], [], 0
    for t, nxt in zip(times, times[1:]):
        while i < len(spans) and spans[i][0] <= t:
            a, b, name = spans[i]
            heapq.heappush(heap, (-a, b, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        if heap:
            name = heap[0][2]
            if out and out[-1][2] == name and out[-1][1] == t:
                out[-1][1] = nxt
            else:
                out.append([t, nxt, name])
    return [tuple(s) for s in out]


def overlap_by_name(idle, stretches) -> dict:
    """Seconds of the idle intervals inside each name's stretches (both
    lists disjoint and sorted, in microseconds)."""
    by_name = collections.defaultdict(float)
    i = j = 0
    while i < len(idle) and j < len(stretches):
        a, b = idle[i]
        c, d, name = stretches[j]
        lo, hi = max(a, c), min(b, d)
        if hi > lo:
            by_name[name] += (hi - lo) / 1e6
        if b <= d:
            i += 1
        else:
            j += 1
    return dict(by_name)


class PortTrace:
    """The window (first request span's start to the last one's end, as
    Summary's), its device idle seconds, and those seconds by the
    innermost nfl.* span open on the host (`idle_by_span`, names without
    the prefix), in all (`idle_port_s`) and outside every one of them
    (`idle_outside_s`)."""

    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        reqs = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                      for e in xs if e.get("cat") == "user_annotation"
                      and e.get("name") == REQUEST)
        if not reqs:
            raise RuntimeError("the trace holds no request span")
        w0, w1 = reqs[0][0], reqs[-1][1]
        self.window_s = (w1 - w0) / 1e6
        self.device_events = sum(1 for e in xs
                                 if e.get("cat") in DEVICE_CATS
                                 and w0 <= float(e["ts"]) < w1)
        spans = []
        for e in xs:
            name = e.get("name", "")
            if e.get("cat") == SPAN_CAT and name.startswith(PREFIX):
                a = max(float(e["ts"]), w0)
                b = min(float(e["ts"]) + float(e["dur"]), w1)
                if b > a:
                    spans.append((a, b, name[len(PREFIX):]))
        self.spans = len(spans)
        idle = idle_intervals(xs, w0, w1)
        self.idle_s = sum(b - a for a, b in idle) / 1e6
        self.idle_by_span = overlap_by_name(idle, innermost(spans))
        self.idle_port_s = sum(self.idle_by_span.values())
        self.idle_outside_s = self.idle_s - self.idle_port_s

    def line(self) -> str:
        """The log's line: idle seconds under each innermost span and
        outside the port."""
        under = ", ".join(f"{k} {v:.6f}" for k, v in sorted(
            self.idle_by_span.items(), key=lambda kv: -kv[1]))
        return (f"port spans: {self.spans} nfl.* spans; device idle "
                f"{self.idle_s:.6f} s of {self.window_s:.6f}: under the "
                f"innermost nfl.* span {{{under}}}, outside the port "
                f"{self.idle_outside_s:.6f} s")
