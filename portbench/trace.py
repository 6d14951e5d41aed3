"""Reading the device from a torch.profiler trace of the measured window.

The harness marks its own calls into each layer of the port with
record_function spans named "portbench.<span>".  From the exported Chrome
trace this module takes:
- busy seconds: the union of the device's kernels, copies and fills inside
  the window (first request span's start to the last one's end);
- each span name's device seconds: the kernels, copies and fills whose
  launch (a CUDA runtime or driver call, linked by its correlation id) lies
  inside one of that name's spans;
- the breakdown: the device operations that took most time, and the idle
  gaps summed by the innermost span the host was in when each began.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile

PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# CUPTI can drop the device activity of a session's first launches: the
# session opens with these fill kernels, outside every span and the window
WARM_UP = 4
TOP = 10


@contextlib.contextmanager
def profiled(device):
    """A CPU + CUDA torch.profiler session; yields a holder whose
    `.events` is the parsed Chrome trace once the block has ended."""
    import torch
    holder = type("Profile", (), {})()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(WARM_UP):
            torch.full((1,), 7, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


class Summary:
    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = collections.defaultdict(list)
        for e in xs:
            if e.get("cat") == "user_annotation" and \
                    e.get("name", "").startswith(PREFIX):
                spans[e["name"][len(PREFIX):]].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        reqs = sorted(spans.pop("request", []))
        if not reqs:
            raise RuntimeError("the trace holds no request span")
        w0, w1 = reqs[0][0], reqs[-1][1]
        self.window_s = (w1 - w0) / 1e6
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS
               and w0 <= float(e["ts"]) < w1]
        self.device_events = len(dev)
        # busy: the union of device intervals, clipped to the window
        ivs = sorted((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                          w1)) for e in dev)
        merged = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        # device seconds by span, through the launch's correlation id
        by_corr = collections.defaultdict(float)
        for e in dev:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                by_corr[corr] += float(e["dur"]) / 1e6
        launches = sorted(
            (float(e["ts"]), e["args"]["correlation"]) for e in xs
            if e.get("cat") in LAUNCH_CATS
            and e.get("args", {}).get("correlation") is not None)
        starts = [t for t, _ in launches]
        self.launch_events = len(launches)
        self.span_device_s = {}
        seen = set()
        for name, ivals in spans.items():
            total = 0.0
            for a, b in ivals:
                for i in range(bisect.bisect_left(starts, a),
                               bisect.bisect_right(starts, b)):
                    corr = launches[i][1]
                    total += by_corr.get(corr, 0.0)
                    seen.add(corr)
            self.span_device_s[name] = total
        self.unlinked_s = sum(s for c, s in by_corr.items() if c not in seen)
        ops = collections.defaultdict(float)
        for e in dev:
            ops[e.get("name", "?")[:160]] += float(e["dur"]) / 1e6
        self.device_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        # idle gaps, by the innermost span open on the host when each began
        # (the harness's spans inside a request follow one another)
        flat = sorted((a, b, name) for name, iv in spans.items()
                      for a, b in iv)
        firsts = [a for a, _, _ in flat]
        gaps, prev = collections.defaultdict(float), w0
        for a, b in merged + [[w1, w1]]:
            if a > prev:
                i = bisect.bisect_right(firsts, prev) - 1
                host = flat[i][2] if i >= 0 and flat[i][1] > prev \
                    else "request"
                gaps[host] += (a - prev) / 1e6
            prev = max(prev, b)
        self.idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]

    def breakdown(self) -> dict:
        return {"device_ops": [[k, v] for k, v in self.device_ops],
                "idle_gaps": [[k, v] for k, v in self.idle_gaps]}
