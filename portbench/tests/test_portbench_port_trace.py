"""The port's own spans and counters as the benchmark reads them: the
device's idle time split by the port's spans (port_trace.py) on synthetic
traces, the counters' readers, and a CPU run whose result carries their
metrics."""
import time
import types

import pytest

from nfllib_tpu_torch import _kernels
from nfllib_tpu_torch.prng import device_sampling
from portbench import run
from portbench.port_trace import PortTrace, innermost
from portbench.trace import Summary

from .conftest import small_cell

LWE = "he128_u32_n16384_q420.lwe"
SEED = 2 ** 31 + 11


def span(name, a, b):
    """The port's spans are "cpu_op" events, the harness's
    "user_annotation" ones."""
    cat = "cpu_op" if name.startswith("nfl.") else "user_annotation"
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}


def kernel(a, b):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": a, "dur": b - a}


# the request [0, 100) us; lwe_graph [10, 50) holds ntt [20, 30); sampler
# [60, 70); the card busy [0, 15), [25, 55), [65, 80), [90, 100).  Idle:
# [15, 25) under lwe_graph then ntt, [55, 65) crossing sampler's start,
# [80, 90) outside every span
EVENTS = [span("portbench.request", 0, 100), span("nfl.lwe_graph", 10, 50),
          span("nfl.ntt", 20, 30), span("nfl.sampler", 60, 70),
          span("nfl.sampler", -40, -5), kernel(-30, -20), kernel(0, 15),
          kernel(25, 55), kernel(65, 80), kernel(90, 100)]


def test_idle_is_split_by_the_innermost_span():
    p = PortTrace(EVENTS)
    assert p.spans == 3          # the span before the window is left out
    assert p.idle_by_span == pytest.approx({"lwe_graph": 5e-6, "ntt": 5e-6,
                                            "sampler": 5e-6})
    assert p.idle_s == pytest.approx(30e-6)
    assert p.idle_outside_s == pytest.approx(15e-6)
    assert "outside the port 0.000015 s" in p.line()


def test_idle_under_the_port_is_at_most_the_summarys_idle():
    p, s = PortTrace(EVENTS), Summary(EVENTS)
    assert p.window_s == s.window_s
    assert p.idle_port_s <= p.idle_s == pytest.approx(s.window_s - s.busy_s)


@pytest.mark.parametrize("drop", ["nfl.", "k"], ids=["no_port_spans",
                                                     "no_device_ops"])
def test_a_trace_without_port_spans_or_device_ops(drop):
    p = PortTrace([e for e in EVENTS if not e["name"].startswith(drop)])
    if drop == "nfl.":
        assert p.spans == 0 and p.idle_port_s == 0
        assert p.idle_outside_s == pytest.approx(30e-6)
    else:
        assert p.device_events == 0 and p.idle_s == pytest.approx(100e-6)
        assert p.idle_by_span == pytest.approx(
            {"lwe_graph": 30e-6, "ntt": 10e-6, "sampler": 10e-6})


def test_innermost_takes_the_later_start_and_merges_runs():
    got = innermost([(0, 10, "a"), (2, 4, "b"), (4, 6, "b"), (8, 12, "c"),
                     (20, 30, "d")])
    assert got == [(0, 2, "a"), (2, 6, "b"), (6, 8, "a"), (8, 12, "c"),
                   (20, 30, "d")]


def test_counter_readers_find_nothing_in_a_port_without_counters(
        monkeypatch):
    from nfllib_tpu_torch import profiling
    monkeypatch.delattr(profiling, "counters")
    monkeypatch.setattr(_kernels, "KERNELS", (types.SimpleNamespace(
        launches=7),))
    for name in ("launch_host_us", "sampler_host_us.lwe"):
        assert run.load_reader(name)(None) is None


def test_a_traced_cpu_run_carries_the_counter_metrics(monkeypatch):
    """Each sampler call makes one stub launch through the wrappers'
    counting helper (no card, no real launch)."""
    lib = _kernels.Library.__new__(_kernels.Library)
    lib.lib = types.SimpleNamespace(nfl_stub=lambda *a: 0)
    sample = device_sampling.device_gaussians

    def sampler(*a, **k):
        _kernels.GAUSSIAN_FIXED._enter(lib, "nfl_stub", (), None,
                                       time.perf_counter_ns())
        return sample(*a, **k)

    monkeypatch.setattr(device_sampling, "device_gaussians", sampler)
    manifest, name, cfg, mix = small_cell(LWE, batch=16)
    res = run.run_cell(manifest, name, cfg, mix, SEED, 0.4, True, "cpu")
    m = res["metrics"]
    assert res["correct"]
    # 3 parts x 16 / 8 draws a call
    assert m["launches_per_request"]["value"] == 6
    assert m["launch_host_us"]["value"] > 0
    assert m["sampler_host_us.lwe"]["value"] > 0
