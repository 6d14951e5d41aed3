"""Builds CUDA sources of nfllib_tpu_torch/csrc with g++ for the host,
against tests/cuda_host_mock.h, for the tests that run the kernels' own
code on the CPU (test_torch_bfly_host.py, test_torch_sampling_host.py,
test_torch_gaussian_kernels.py, test_torch_hwt_kernels.py,
test_torch_modops_expr.py).

Each source is rewritten as it is copied: the CUDA runtime include becomes
the mock, the dynamic shared-memory declaration a pointer to mock_smem,
and every `kernel<<<grid, block, smem, stream>>>(args)` a
mock_launch(kernel, grid, block, smem, stream, args).  The library also
exports mock_launches(), the launches since its last call, and
mock_grid_x(), grid.x of the last launch.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "nfllib_tpu_torch" / "csrc"
MOCK = pathlib.Path(__file__).resolve().parent / "cuda_host_mock.h"


def build(out: pathlib.Path, names, sources, extra=None) -> ctypes.CDLL:
    """Copy `names` (sources and headers of csrc/) into `out` rewritten for
    the mock, compile `sources` among them and the test's own C++ files
    `extra` ({name: text}, which may include the mock as "MOCK" and the
    copied headers) into one shared library and load it; skips the calling
    test when there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the host")
    for name in names:
        s = (CSRC / name).read_text()
        s = s.replace("#include <cuda_runtime.h>", f'#include "{MOCK}"')
        s = s.replace("extern __shared__ __align__(16) unsigned char "
                      "smem_raw[];", "unsigned char* smem_raw = mock_smem;")
        s = re.sub(r"([\w:]+(?:<[^;<>]*>)?)<<<(.*?)>>>\(",
                   r"mock_launch(\1, \2, ", s, flags=re.S)
        (out / name).write_text(s)
    for name, text in (extra or {}).items():
        (out / name).write_text(text.replace('"MOCK"', f'"{MOCK}"'))
    (out / "count.cpp").write_text(
        f'#include "{MOCK}"\nextern "C" int mock_launches() '
        "{ int n = mock_launch_count; mock_launch_count = 0; return n; }\n"
        'extern "C" unsigned mock_grid_x() { return gridDim.x; }\n')
    so = out / "libhost_kernels.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-x", "c++", *(str(out / s) for s in sources),
                    *(str(out / name) for name in (extra or {})),
                    str(out / "count.cpp"), "-o", str(so)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(so))
