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

import pytest
import torch

from nfllib_tpu import profiling as jprofiling
from nfllib_tpu_torch import profiling

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
