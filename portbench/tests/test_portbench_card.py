"""On the card: one short run of each cell is correct (skipped without a
card; run with `python3 -m pytest portbench/tests -m card`)."""
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          cell, "--seed", "2147483700", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
