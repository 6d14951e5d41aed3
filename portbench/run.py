"""Run one cell of BENCHMARK.json once on the card and print its result.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from the harness's first line): the port's
import and the card's context, the kernel library (built into the port's
own build directory inside the checkout at a cell's first run there, then
loaded), the inputs made on the card from the seed, the port's own set-up
of the mix, and WARMUP requests.  Then requests run back to back, each
enqueued whole and then synchronised, until `--seconds` have passed.  With
`--trace 1` the window's last part (half, at most TRACE_SECONDS) runs under
torch.profiler, with the harness's spans around its calls into each
layer; the host-clock per-layer readings come from the part before it,
which runs as an untraced window does.  After the window: the peak device
memory, the check that no JAX module was loaded, the program's state
freed, and the sampled requests compared with the plain reference.  The
last line of standard output is one JSON object; each compared number also
ends standard error.

Every metric is read by a file of its own, found by its name in
BENCHMARK.json: end_to_end/<name>.py or layers/<name>.py, whose
`read(run)` takes a `Run` and returns a number, or None where it finds
nothing to read.

It sets no knob or environment variable of the port: every cell measures
its defaults.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import pathlib
import random
import resource
import subprocess
import sys
import time

from . import T0

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nfllib_tpu")
WARMUP = 2          # requests in set-up: every shape the window uses
TRACE_SECONDS = 10  # the most a traced run's profiled part lasts


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_manifest(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, name: str):
    """(cell, configuration file's dict, mix file's dict) of a cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(ROOT / conf["file"]) as f:
        cfg = json.load(f)
    with open(HERE / "mixes" / f"{cell['traffic']}.json") as f:
        mix = json.load(f)
    return cell, cfg, mix


def applies(metric: dict, cell: str, reported=()) -> bool:
    """Whether a metric belongs to a cell: listed there, or unlisted and
    moving an end-to-end metric that the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_reader(name: str, folder: str = "layers"):
    """`read` of <folder>/<name>.py."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Spans:
    """The harness's spans: the bound's bytes by name, and with tracing a
    record_function("portbench.<name>") around each."""

    def __init__(self, tracing: bool):
        self.tracing = tracing
        self.bytes = {}

    def __call__(self, name: str, nbytes: int = 0):
        self.bytes[name] = self.bytes.get(name, 0) + nbytes
        if self.tracing:
            import torch
            return torch.profiler.record_function("portbench." + name)
        return _Null()


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Window:
    """The requests of one stretch of the window, untraced or traced."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.latencies_ms = []
        self.enqueue_ms = []
        self.launches = 0
        self.trace = None
        self.seconds = 0.0

    @property
    def requests(self) -> int:
        return len(self.latencies_ms)


class Run:
    """What a metric's reader reads: `setup_s`, `units_per_request` (the
    kind's work units in one request), `host` (the untraced window: the
    whole of it with --trace 0, the part before the profiled one with
    --trace 1) and `traced` (the profiled part, a Window whose `trace` is a
    trace.Summary; None with --trace 0)."""

    def __init__(self, setup_s: float, units_per_request: int,
                 host: Window, traced: Window | None):
        self.setup_s, self.units_per_request = setup_s, units_per_request
        self.host, self.traced = host, traced


class Sample:
    """A uniform sample of `keep` requests over all of a run's window."""

    def __init__(self, keep: int, seed: int):
        self.keep, self.rng = keep, random.Random(seed)
        self.seen, self.kept = 0, {}

    def add(self, r: int, out) -> None:
        if len(self.kept) < self.keep:
            self.kept[r] = out
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.keep:
                del self.kept[sorted(self.kept)[j]]
                self.kept[r] = out
        self.seen += 1


def launch_total() -> int:
    from nfllib_tpu_torch import _kernels
    return sum(k.launches for k in _kernels.KERNELS)


def host_usage(before=None, wall: float = 0.0):
    """The process's CPU seconds and the collector's full collections;
    with `before`, what they grew by over a window of `wall` seconds, as a
    line for the log (whether a slow host-paced window lost the CPU, and
    whether garbage that only a full collection frees was freed)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    now = (ru.ru_utime + ru.ru_stime, gc.get_stats()[2]["collections"])
    if before is None:
        return now
    cpu, full = (a - b for a, b in zip(now, before))
    return f"cpu {cpu:.3f} s of {wall:.3f} s wall, {full} full collections"


def latency_profile(ms) -> str:
    """Quantiles of a window's latencies and the requests that took over
    twice the median, as a line for the log (whether a slow window was
    slow throughout or stalled now and then)."""
    s = sorted(ms)
    q = {k: s[min(len(s) - 1, int(k * len(s)))] for k in (0.5, 0.95, 0.99)}
    slow = [x for x in s if x > 2 * q[0.5]]
    return (f"p50 {q[0.5]:.3f}, p95 {q[0.95]:.3f}, p99 {q[0.99]:.3f}, max "
            f"{s[-1]:.3f} ms; {len(slow)} over twice the median, "
            f"{sum(slow) / 1e3:.3f} s in all")


def measure(kind, seconds: float, sample: Sample, tracing: bool, sync,
            first: int) -> Window:
    """Requests from `first` on, back to back, for `seconds`."""
    w = Window(Spans(tracing))
    launches0 = launch_total()
    r = first
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with w.spans("request"):
            out = kind.request(r, w.spans)
            t1 = time.perf_counter()
            sync()
        t2 = time.perf_counter()
        w.enqueue_ms.append((t1 - t0) * 1e3)
        w.latencies_ms.append((t2 - t0) * 1e3)
        sample.add(r, out)
        r += 1
        if t2 - start >= seconds:
            break
    w.seconds = t2 - start
    w.launches = launch_total() - launches0
    return w


def run_cell(manifest: dict, name: str, cfg: dict, mix: dict, seed: int,
             seconds: float, trace: bool, device) -> dict:
    """One run of a cell on `device` (the card, or the CPU in tests); the
    result's dict, with its checks under "checks"."""
    import torch
    import nfllib_tpu_torch as port
    from . import traffic
    from .trace import Summary, profiled

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    kind = traffic.load_kind(mix["kind"])(port, cfg, mix, seed, dev)
    kind.setup()
    for r in range(WARMUP):
        kind.request(r, Spans(False))
    sync()
    setup_s = time.perf_counter() - T0
    log(f"{name}: batch {kind.batch}, set-up {setup_s:.3f} s")
    sample = Sample(int(mix.get("keep", 4)), seed)
    traced_s = min(seconds / 2, TRACE_SECONDS) if trace else 0.0
    host0 = host_usage()
    host = measure(kind, seconds - traced_s, sample, False, sync, WARMUP)
    log(f"host over the untraced window: {host_usage(host0, host.seconds)}")
    log(f"latency: {latency_profile(host.latencies_ms)}")
    traced = None
    if trace:
        first = WARMUP + host.requests
        with profiled(dev) as prof:
            traced = measure(kind, traced_s, sample, True, sync, first)
        traced.trace = Summary(prof.events)
    windows = [w for w in (host, traced) if w is not None]
    attempted = sum(w.requests for w in windows)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"{' + '.join(str(w.requests) for w in windows)} requests in "
        f"{' + '.join(f'{w.seconds:.6f}' for w in windows)} s, "
        f"{sum(w.launches for w in windows)} port launches")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")

    kept = sample.kept
    kind.release()
    t = time.perf_counter()
    checks = kind.check(kept)
    log(f"reference check of {len(kept)} sampled requests: "
        f"{time.perf_counter() - t:.3f} s")
    limits = {k: int(v) for k, v in mix["limits"].items()}
    if set(limits) != set(checks):
        raise RuntimeError(f"the mix's limits {sorted(limits)} are not the "
                           f"check's numbers {sorted(checks)}")
    correct = bool(kept) and all(checks[k] <= limits[k] for k in checks)
    failed = 0 if correct else len(kept)

    readings = Run(setup_s, kind.units_per_request, host, traced)
    reported = [m["name"] for m in manifest["end_to_end"]
                if applies(m, name)]
    if trace:
        wanted = [(m, "layers") for m in manifest["per_layer"]
                  if applies(m, name, reported)]
    else:
        wanted = [(m, "end_to_end") for m in manifest["end_to_end"]
                  if applies(m, name)]
    metrics = {}
    for m, folder in wanted:
        v = load_reader(m["name"], folder)(readings)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(dev)
                         if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if trace:
        s = traced.trace
        result["device"].update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = s.breakdown()
        log(f"trace: {s.device_events} device operations, busy "
            f"{s.busy_s:.6f} of {s.window_s:.6f} s, span device s "
            f"{json.dumps(s.span_device_s)}, unlinked {s.unlinked_s:.6f} s, "
            f"{s.launch_events} launch events")
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in checks}
    return result


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave no answer"


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    manifest = load_manifest()
    cell, cfg, mix = find_cell(manifest, args.workload)
    import torch
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); this process "
            f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" (torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}): no result")
        return 2
    result = run_cell(manifest, args.workload, cfg, mix, args.seed,
                      args.seconds, bool(args.trace), "cuda:0")
    log(card_line())
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0
