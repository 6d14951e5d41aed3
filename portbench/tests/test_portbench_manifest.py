"""BENCHMARK.json against the benchmark's contract, and every cell, mix,
configuration and per-layer metric found by its name."""
import json
import pathlib
import re

import pytest

from portbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
WIDTHS = re.compile(r"_dim$|_rank$|hidden|intermediate|latent|state|"
                    r"projection|head|expansion|degree|prime_bits|primes")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert M["paths"] == ["portbench"]
    assert all(line(w) for w in M["command"]) and len(M["command"]) <= 32
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 180 s a cell to compile and 1200 s spare, within 12 hours
    cells = 24
    total = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    entries = M[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert line(e[k]), (e["name"], k)


def test_end_to_end_metrics():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in M["end_to_end"]}["setup_s"] \
        == 0.25


def test_per_layer_metrics_have_readers_and_move_reported_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert callable(run.load_reader(m["name"], "layers"))
        for cell in m.get("workloads", []):
            assert run.applies(e2e[m["moves"]], cell), (m["name"], cell)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    layers = {}
    for m in M["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cells_are_found_and_report_enough(cell):
    w, cfg, mix = run.find_cell(M, cell)
    assert w["chips"] == 1
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    e2e = [m["name"] for m in M["end_to_end"] if run.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert all(callable(run.load_reader(m, "end_to_end")) for m in e2e)
    per = [m for m in M["per_layer"] if run.applies(m, cell, e2e)]
    assert per
    from portbench import traffic
    kind = traffic.load_kind(mix["kind"])
    assert issubclass(kind, traffic.Kind)
    assert mix["limits"] and all(v == 0 for v in mix["limits"].values())


@pytest.mark.parametrize("conf", M["configs"], ids=lambda c: c["name"])
def test_configurations(conf):
    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert conf["file"].startswith("portbench/configs/")
    assert cfg["name"] == conf["name"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert not any(WIDTHS.search(k) for k in conf["reduced"])
    assert len(cfg["primes"]) == len(cfg["primitive_roots"]) == \
        cfg["nmoduli"] == cfg["modulus_bits"] // cfg["prime_bits"]
    # the HE standard's 128-bit bound on log q at this degree
    bound = {16384: 438, 32768: 881}[cfg["degree"]]
    import math
    logq = sum(math.log2(p) for p in cfg["primes"])
    assert logq <= cfg["modulus_bits"] <= bound
    used = {w["config"] for w in M["workloads"]}
    assert conf["name"] in used


def test_the_ports_rings_have_the_configured_primes():
    import nfllib_tpu_torch as port
    for conf in M["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        ring = port.ring_from_modulus(cfg["limb"], cfg["degree"],
                                      cfg["modulus_bits"])
        assert [int(p) for p in ring.moduli] == cfg["primes"]
        assert ring.shape == (cfg["nmoduli"], cfg["degree"])
