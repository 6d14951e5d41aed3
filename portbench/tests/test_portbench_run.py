"""The run's parts on the CPU at a small size: kinds and readers found by
name, the traced run's host readings taken outside the profiler, readers
that find nothing return nothing, and the sampler span holding only the
port's samplers."""
import contextlib
import pathlib

import pytest
import torch

import nfllib_tpu_torch as port
from nfllib_tpu_torch.prng import device_sampling
from portbench import run, traffic

from .conftest import small_cell

BENCH = pathlib.Path(__file__).resolve().parents[1]
LWE = "he128_u32_n16384_q420.lwe"
SEED = 2 ** 31 + 7


@pytest.mark.parametrize("path", sorted((BENCH / "kinds").glob("[a-z]*.py")),
                         ids=lambda p: p.stem)
def test_each_kind_file_is_found_by_its_name(path):
    kind = traffic.load_kind(path.stem)
    assert issubclass(kind, traffic.Kind)
    for name in ("setup", "request", "check", "control_request"):
        assert callable(getattr(kind, name))


@pytest.mark.parametrize("name", ["no_such_kind", "../run", "kinds.lwe"])
def test_an_unknown_kind_is_refused(name):
    with pytest.raises((ValueError, ModuleNotFoundError)):
        traffic.load_kind(name)


def test_a_traced_run_reads_host_metrics_outside_the_profiler():
    manifest, name, cfg, mix = small_cell(LWE, batch=8)
    res = run.run_cell(manifest, name, cfg, mix, SEED, 0.4, True, "cpu")
    m = res["metrics"]
    assert res["correct"]
    assert m["enqueue_ms"]["value"] > 0
    assert m["launches_per_request"]["value"] == 0     # no card, no launch
    # nothing ran on a device: the device readers find nothing to read
    for gone in ("lwe_graph_roofline.lwe", "sampler_device_ms.lwe"):
        assert gone not in m
    assert res["device"]["busy_s"] == 0 and res["device"]["window_s"] > 0


def test_an_untraced_run_reports_the_cells_end_to_end_metrics():
    manifest, name, cfg, mix = small_cell(LWE, batch=8)
    res = run.run_cell(manifest, name, cfg, mix, SEED, 0.2, False, "cpu")
    assert set(res["metrics"]) == {"lwe_pairs_per_s", "request_p95_ms",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_the_sampler_span_holds_only_the_ports_samplers(monkeypatch):
    manifest, name, cfg, mix = small_cell(LWE, batch=16)
    kind = traffic.load_kind(mix["kind"])(port, cfg, mix, SEED, "cpu")
    kind.setup()
    open_spans, inside, seen = [], [], []

    @contextlib.contextmanager
    def span(name, nbytes=0):
        open_spans.append(name)
        yield
        open_spans.pop()

    sample = device_sampling.device_gaussians

    def sampler(*a, **k):
        seen.append(open_spans[-1])
        inside.append(1)
        try:
            return sample(*a, **k)
        finally:
            inside.pop()

    cat, cats = torch.cat, []

    def recorded_cat(*a, **k):
        if not inside:
            cats.append(open_spans[-1] if open_spans else None)
        return cat(*a, **k)

    monkeypatch.setattr(device_sampling, "device_gaussians", sampler)
    monkeypatch.setattr(torch, "cat", recorded_cat)
    kind.request(0, span)
    assert seen and set(seen) == {"sampler"}
    assert "sampler" not in cats and "noise_cat" in cats


def test_the_sample_is_drawn_over_the_whole_window():
    hits = [0] * 40
    for seed in range(300):
        s = run.Sample(4, seed)
        for r in range(40):
            s.add(r, None)
        assert len(s.kept) == 4
        for r in s.kept:
            hits[r] += 1
    # each request is kept with probability 4 / 40: 30 of 300 on average
    assert min(hits) > 10 and max(hits) < 55
