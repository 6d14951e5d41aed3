"""Build, load and launch the port's hand-written CUDA kernels.

The sources in csrc/ have a plain C interface: they are compiled with nvcc
into a shared library at first use (into _build/, keyed by a hash of the
sources and flags) and loaded with ctypes.  Tensors pass as raw device
pointers, on PyTorch's current stream.  Nothing here runs at import time,
and there is no fallback: a missing nvcc, a failed build or a refused
launch raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_SOURCES = (_PKG / "csrc" / "ntt_fused.cu",)
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nfllib_tpu_torch: nvcc not found (set CUDA_HOME); "
                       "the CUDA kernels cannot be built")


class Library:
    """The loaded kernel library and what its build printed."""

    def __init__(self, path: pathlib.Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        self.log = log                       # nvcc/ptxas output of the build
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.nfl_ntt_fused.argtypes = [i32, i32, i32] + [ptr] * 10 \
            + [i32] * 4 + [ptr]
        lib.nfl_ntt_fused.restype = i32
        lib.nfl_cuda_error_string.argtypes = [i32]
        lib.nfl_cuda_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.nfl_cuda_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=1)
def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    path = _BUILD_DIR / f"libnfl_kernels_{h.hexdigest()[:16]}.so"
    if path.exists():
        return Library(path, 0.0, "")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(
            f"nfllib_tpu_torch: kernel build failed ({' '.join(cmd)}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, path)
    return Library(path, seconds, res.stdout + res.stderr)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class FusedNttKernel:
    """Wrapper of one direction of csrc/ntt_fused.cu with its launch count:
    `launches` grows by one for each kernel launch and nowhere else."""

    def __init__(self, name: str, inverse: bool):
        self.name = name
        self.inverse = inverse
        self.launches = 0

    def __call__(self, x: torch.Tensor, tables, strict: bool) -> torch.Tensor:
        """x: contiguous CUDA [B, m, n] int32 (u32) / int16 (u16) residues
        -> new tensor of the same shape."""
        m, n1, n2 = tables.m, tables.n1, tables.n2
        want = torch.int16 if tables.ndig == 2 else torch.int32
        if not x.is_cuda or x.dtype != want or x.dim() != 3 \
                or x.shape[1:] != (m, n1 * n2) or not x.is_contiguous():
            raise ValueError(
                f"{self.name}: expected a contiguous CUDA {want} tensor "
                f"[B, {m}, {n1 * n2}], got {x.dtype} {tuple(x.shape)} "
                f"on {x.device}")
        if tables.device != x.device:
            raise ValueError(f"{self.name}: tables on {tables.device}, "
                             f"data on {x.device}")
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        lib = library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.lib.nfl_ntt_fused(
                int(self.inverse), int(tables.ndig == 2), int(strict),
                _ptr(x), _ptr(out), _ptr(tables.w1), _ptr(tables.w2),
                _ptr(tables.tw), _ptr(tables.tws), _ptr(tables.corr1),
                _ptr(tables.corr2), _ptr(tables.p), _ptr(tables.mbar),
                x.shape[0], m, n1, n2, ctypes.c_void_p(stream))
        lib.check(err, self.name)
        self.launches += 1
        return out


NTT_FUSED_FWD = FusedNttKernel("ntt_fused_fwd", inverse=False)
NTT_FUSED_INV = FusedNttKernel("ntt_fused_inv", inverse=True)
KERNELS = (NTT_FUSED_FWD, NTT_FUSED_INV)
