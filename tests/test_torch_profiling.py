"""The port's profiling helpers (nfllib_tpu_torch/profiling.py, on
torch.profiler) beside nfllib_tpu/profiling.py's contract: `trace` writes
a trace file that names an `annotate` region, `WallTimer` counts and
means; and the port's modules import no JAX (checked in subprocesses, as
the card's machine has no jax)."""
import json
import os
import subprocess
import sys
import time
import types

import pytest
import torch

from nfllib_tpu import profiling as jprofiling
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import profiling
from nfllib_tpu_torch.apps import lwe as tlwe

DEV = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_a_file_naming_the_annotation(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)):
        with profiling.annotate("nfl_region"):
            x = torch.arange(1000, dtype=torch.int64) * 7
            y = (x % 13).sum()
    assert int(y) == int(((torch.arange(1000) * 7) % 13).sum())
    files = sorted(log_dir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "nfl_region" in names
    region = next(e for e in events if e.get("name") == "nfl_region")
    inside = [e for e in events if e.get("name", "").startswith("aten::")
              and region["ts"] <= e["ts"] <= region["ts"] + region["dur"]]
    assert inside, "no torch op recorded inside the annotated region"


def test_wall_timer_counts_and_means():
    timers = [profiling.WallTimer(), jprofiling.WallTimer()]
    for t in timers:
        assert t.count == 0 and t.mean_us == 0.0
        for _ in range(3):
            with t.measure():
                time.sleep(0.002)
        assert t.count == 3
        assert 2000.0 <= t.mean_us < 1e6
        assert t.mean_us == pytest.approx(t.total / 3 * 1e6)
    with pytest.raises(RuntimeError):
        with timers[0].measure():
            raise RuntimeError("inside")
    assert timers[0].count == 4


_NO_JAX = (
    "import sys\n"
    "{imports}\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'nfllib_tpu'))\n"
    "assert not bad, bad\n"
    "print('ok', len([m for m in sys.modules "
    "if m.startswith('nfllib_tpu_torch')]))\n")


@pytest.mark.parametrize("what", ["native_profiling", "every_module"])
def test_port_imports_no_jax(what):
    if what == "native_profiling":
        imports = "import nfllib_tpu_torch.native, nfllib_tpu_torch.profiling"
    else:
        # every module of the port, and chip_smoke.py's top level
        imports = (
            "import importlib, pkgutil, runpy\n"
            "import nfllib_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "runpy.run_path('chip_smoke.py', run_name='chip_smoke')")
    res = subprocess.run([sys.executable, "-c", _NO_JAX.format(
        imports=imports)], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    word, count = res.stdout.split()
    assert word == "ok" and int(count) >= (3 if what == "native_profiling"
                                           else 30)


# ---------------------------------------------------------------------------
# The port's spans and launch counters
# ---------------------------------------------------------------------------

def _no_record_function(monkeypatch):
    """Make every way into a profiler record raise: record_function, the
    cheaper _RecordFunctionFast, and the records the spans hold."""
    def refuse(*a, **k):
        raise AssertionError("profiler record made with no profiler active")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    for cls in (profiling.annotate, profiling.span):
        monkeypatch.setattr(cls, "_record", refuse)


def _products_request(ring):
    stream = tnfl.prng.Salsa20Stream(bytes(range(32)))
    a, b = (tnfl.Poly.sample(ring, tnfl.uniform(), stream, DEV)
            for _ in range(2))
    return lambda: (a.ntt_pow_phi() * b.ntt_pow_phi()).poly() \
        .invntt_pow_invphi()


def _lwe_request(ring):
    g = tlwe.make_gaussian_prng()
    keys = tlwe.keygen(ring, tnfl.prng.Salsa20Stream(bytes(range(32))), g,
                       DEV)

    def request():
        resa, resb = tlwe.encrypt_on_device(keys, ring, bytes(range(32)), 5,
                                            g)
        bits = tlwe.decrypt(keys, ring, resa, resb)
        assert not bits.any()
    request()                      # the sampler's tables, outside the trace
    return request


@pytest.mark.parametrize("what", ["span", "annotate", "products", "lwe"])
def test_no_record_function_without_a_profiler(monkeypatch, what):
    monkeypatch.delenv("NFL_TORCH_NTT", raising=False)
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    request = {"products": _products_request, "lwe": _lwe_request}.get(
        what, lambda r: None)(ring)
    _no_record_function(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    before = profiling.counters()
    if request is not None:
        request()
        labels = {"products": ("nfl.ntt", "nfl.expr_trace", "nfl.e1"),
                  "lwe": ("nfl.sampler", "nfl.lwe_graph", "nfl.ntt",
                          "nfl.e1")}[what]
    else:
        label = "nfl.off_check" if what == "span" else "off_check"
        cls = getattr(profiling, what)
        for _ in range(3):
            with cls("off_check"):
                time.sleep(0.0005)
        labels = (label,)
    after = profiling.counters()
    for label in labels:
        calls0, ns0 = before.get(label, (0, 0))
        calls, ns = after[label]
        assert calls > calls0 and ns > ns0
    if request is None:
        assert after[labels[0]][0] - before.get(labels[0], (0, 0))[0] == 3
        assert after[labels[0]][1] - before.get(labels[0], (0, 0))[1] \
            >= 3 * 500_000


def _nfl_spans(prof, tmp_path):
    """The trace's nfl.* spans as (name, start, end, enclosing nfl.* span's
    name or None), in order of start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                    for e in events if e.get("cat") == "cpu_op"
                    and e.get("name", "").startswith("nfl.")),
                   key=lambda s: (s[1], -s[2]))
    out, open_ = [], []
    for name, a, b in spans:
        while open_ and open_[-1][2] <= a:
            open_.pop()
        assert not open_ or b <= open_[-1][2], "spans that cross"
        out.append((name, a, b, open_[-1][0] if open_ else None))
        open_.append((name, a, b))
    return out


@pytest.mark.parametrize("what", ["products", "lwe"])
def test_port_spans_nest_under_the_profiler(monkeypatch, tmp_path, what):
    monkeypatch.delenv("NFL_TORCH_NTT", raising=False)
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    request = {"products": _products_request, "lwe": _lwe_request}[what](
        ring)
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        request()
    after = profiling.counters()
    spans = _nfl_spans(prof, tmp_path)
    if what == "products":
        # a.ntt_pow_phi(), b.ntt_pow_phi(), the product's trace and its
        # E1, the inverse
        want = [("nfl.ntt", None), ("nfl.ntt", None),
                ("nfl.expr_trace", None), ("nfl.e1", None), ("nfl.ntt", None)]
    else:
        # the three draws in one S3 call; the encrypt graph's three
        # transforms and two muladds; decryption's program and inverse
        want = [("nfl.sampler", None), ("nfl.lwe_graph", None)] \
            + [("nfl.ntt", "nfl.lwe_graph")] * 3 \
            + [("nfl.e1", "nfl.lwe_graph")] * 2 \
            + [("nfl.lwe_graph", None), ("nfl.e1", "nfl.lwe_graph"),
               ("nfl.ntt", "nfl.lwe_graph")]
    assert [(name, parent) for name, _, _, parent in spans] == want
    for label in {name for name, _ in want}:
        calls = sum(1 for name, _ in want if name == label)
        assert after[label][0] - before.get(label, (0, 0))[0] == calls


def _pair_sum(polys):
    """A balanced sum of the products of consecutive pairs of `polys`."""
    terms = [polys[k] * polys[k + 1] for k in range(0, len(polys), 2)]
    while len(terms) > 1:
        terms = [terms[k] + terms[k + 1] if k + 1 < len(terms) else terms[k]
                 for k in range(0, len(terms), 2)]
    return terms[0]


@pytest.mark.parametrize("tree", ["one_program", "past_the_caps"])
def test_expr_trace_span_holds_from_expr(tmp_path, tree):
    """A forced Expr is one call of `nfl.expr_trace` (from_expr), its E1
    after it.  A tree past the caps (9 products of 18 leaves: more than
    MAX_LEAVES) forces one subtree inside it: that subtree's own trace and
    its `nfl.e1` lie inside the root's `nfl.expr_trace`."""
    from nfllib_tpu_torch.ops import expr_program
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    stream = tnfl.prng.Salsa20Stream(bytes(range(32)))
    polys = [tnfl.Poly.sample(ring, tnfl.uniform(), stream, DEV)
             for _ in range(3 if tree == "one_program" else 18)]
    if tree == "one_program":
        expr = polys[0] * polys[1] + polys[2]
        want = [("nfl.expr_trace", None), ("nfl.e1", None)]
    else:
        expr = _pair_sum(polys)
        assert not expr_program._Tracer(expr).program().fits()
        want = [("nfl.expr_trace", None),
                ("nfl.expr_trace", "nfl.expr_trace"),
                ("nfl.e1", "nfl.expr_trace"), ("nfl.e1", None)]
    before = profiling.counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        expr.poly()
    after = profiling.counters()
    assert [(name, parent) for name, _, _, parent in
            _nfl_spans(prof, tmp_path)] == want
    for label in ("nfl.expr_trace", "nfl.e1"):
        calls0, ns0 = before.get(label, (0, 0))
        calls, ns = after[label]
        assert calls - calls0 == sum(1 for name, _ in want if name == label)
        assert ns > ns0


class _StubLib:
    """A kernel library's C side: entry points that record their arguments
    and return `err`."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def nfl_stub(self, *args):
        self.calls.append(args)
        return self.err

    def nfl_hwt_state_bytes(self):
        return 16

    def nfl_cuda_error_string(self, err):
        return b"stub error"


@pytest.mark.parametrize("err", [0, 700])
@pytest.mark.parametrize("wrapper", ["launch", "hwt_run"])
def test_one_helper_counts_launches_and_host_ns(monkeypatch, wrapper, err):
    from nfllib_tpu_torch import _kernels
    stub = _StubLib(err)
    lib = _kernels.Library.__new__(_kernels.Library)
    lib.lib = stub
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    # a CPU tensor's device index (None) taken for the current device
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index=None: types.SimpleNamespace(
                            cuda_stream=77))
    monkeypatch.setattr(_kernels, "_raw_stream", lambda index: 77)
    seen = []
    enter = _kernels._Wrapper._enter

    def spy(self, *a):
        seen.append(self.name)
        return enter(self, *a)
    monkeypatch.setattr(_kernels._Wrapper, "_enter", spy)
    x = torch.zeros(4, dtype=torch.int64)
    if wrapper == "launch":
        w = _kernels.GaussianFixedKernel("stub_s3")
        call = lambda: w._launch(x, "nfl_stub", 1, 2)         # noqa: E731
    else:
        w = _kernels.HwtFixedKernel("stub_s5")
        plan = _kernels.HwtPlan(True, 32, 2, 1, 0)
        call = lambda: w._run(x, "nfl_stub", plan,            # noqa: E731
                              lambda state, scratch: (1, 2))
    if err:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            call()
        assert (w.launches, w.host_ns) == (0, 0)
    else:
        call()
        call()
        assert w.launches == 2 and w.host_ns > 0
    assert seen == [w.name] * len(stub.calls)
    assert all(c[:2] == (1, 2) and int(getattr(c[2], "value", c[2])) == 77
               for c in stub.calls)
