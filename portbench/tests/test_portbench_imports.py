"""Nothing of the benchmark loads JAX or the JAX package, the reference
loads nothing of the port, and the measuring path refuses to run
without a card."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "nfllib_tpu"}


def imported(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    tops = {m.split(".")[0] for m in imported(BENCH / "reference.py")}
    assert tops <= {"__future__", "math", "torch", "mpmath"}


def run_portbench(cwd, *args, env=None):
    return subprocess.run([sys.executable, "-m", "portbench", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_loading_the_harness_loads_no_jax():
    code = ("import sys, portbench.run, portbench.traffic, portbench.trace, "
            "portbench.control, portbench.reference, portbench.kinds.lwe, "
            "portbench.kinds.macc, portbench.kinds.products, "
            "nfllib_tpu_torch._kernels, nfllib_tpu_torch.apps.lwe; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_portbench(ROOT, "--workload", "he128_u32_n16384_q420.products",
                        "--seed", "2147483999", "--seconds", "1", "--trace",
                        "0", env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_portbench(tmp_path, "--workload",
                        "he128_u64_n32768_q868.macc", "--seed", "1",
                        "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "{" not in out.stdout
