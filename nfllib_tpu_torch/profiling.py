"""Profiling / tracing helpers.

Port of nfllib_tpu/profiling.py (SURVEY.md §5: the reference has only
chrono/rdtsc micro-timers in its benchmark mains — tests/tools.h:28-33,
FastGaussianNoise.hpp:116-122).  The JAX package's jax.profiler device
trace becomes a torch.profiler trace; the wall timer is unchanged.

The port's spans: `span(name)` at each layer boundary of the port
(`nfl.ntt`, `nfl.e1`, `nfl.lwe_graph`, `nfl.sampler`, and `nfl.expr_trace`
around `ops/expr_program.py:from_expr`, an `Expr` traced into E1's
programs, which holds the `nfl.e1` of a subtree it forces).  Any
torch.profiler session shows them as ranges on the profiler's clock,
beside the CUPTI kernel, copy and launch events; with no session
recording a span makes no profiler record.  Either way each span adds its
calls and inclusive host ns to the table that `counters()` returns.
"""
from __future__ import annotations

import contextlib
import time

import torch

_enabled = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns

# label -> [label, calls, inclusive host ns]: every span and annotation of
# the process.  Kept without a lock: spans of concurrent host threads may
# lose an increment.
_TABLE: dict = {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block into `log_dir`: CPU
    activity, and CUDA activity (kernels, copies) when the process has a
    card.  It writes one Chrome trace file, `<host>_<pid>.<time>.pt.trace.json`,
    that TensorBoard's profiler plugin and Perfetto read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class annotate:
    """Named region inside a trace, under `name` as given: a
    record_function (a "user_annotation" event) while a torch.profiler
    session records, none otherwise; its calls and inclusive host ns go to
    `counters()`.  A class, not a generator: off, it costs one check of the
    profiler, two clock reads and two additions."""

    __slots__ = ("_cell", "_rf", "_t0")
    _prefix = ""
    _record = torch.profiler.record_function
    _cells: dict = {}          # name -> its row of _TABLE

    def __init__(self, name: str):
        self._cell = self._cells.get(name) or self._row(name)

    @classmethod
    def _row(cls, name: str) -> list:
        label = cls._prefix + name
        row = cls._cells[name] = _TABLE.setdefault(label, [label, 0, 0])
        return row

    def __enter__(self):
        rf = None
        if _enabled():
            rf = self._record(self._cell[0])
            rf.__enter__()
        self._rf = rf
        self._t0 = _clock()
        return self

    def __exit__(self, et, ev, tb):
        ns = _clock() - self._t0
        cell = self._cell
        cell[1] += 1
        cell[2] += ns
        if self._rf is not None:
            self._rf.__exit__(et, ev, tb)
        return False


class span(annotate):
    """The port's span at a layer boundary: `annotate("nfl." + name)`, its
    record the cheaper "cpu_op" event (a request of the LWE demo's batch
    enters about a hundred).  Nesting on the host thread gives the parent
    (and, inside a caller's span, the request); a span's self time is its
    duration in the trace less what its child spans cover."""

    __slots__ = ()
    _prefix = "nfl."
    # the profiler's record without record_function's Python layer: a
    # "cpu_op" event, a quarter of record_function's host cost under a
    # CPU + CUDA session (about 4 against 17 us a span on an H100
    # machine's host)
    _record = torch._C._profiler._RecordFunctionFast
    _cells: dict = {}


def counters() -> dict:
    """A snapshot of every span's and annotation's counters: {label:
    (calls, inclusive host ns)}, labels as the trace names them."""
    return {label: (calls, ns) for label, calls, ns in list(_TABLE.values())}


class WallTimer:
    """Chrono-style accumulator (reference tests/tools.h:28-33)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total += time.perf_counter() - t0
            self.count += 1

    @property
    def mean_us(self) -> float:
        return (self.total / self.count) * 1e6 if self.count else 0.0
