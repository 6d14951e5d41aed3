"""Profiling / tracing helpers.

Port of nfllib_tpu/profiling.py (SURVEY.md §5: the reference has only
chrono/rdtsc micro-timers in its benchmark mains — tests/tools.h:28-33,
FastGaussianNoise.hpp:116-122).  The JAX package's jax.profiler device
trace becomes a torch.profiler trace; the wall timer is unchanged.
"""
from __future__ import annotations

import contextlib
import time

import torch


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


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield


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
