"""Build, load and launch the port's hand-written CUDA kernels.

The sources in csrc/ have a plain C interface: at first use each .cu file is
compiled by its own nvcc process, all started together, and the objects
are linked into one shared library (into _build/, keyed by a hash of the
sources, headers and flags), loaded with ctypes.  Tensors pass as raw device
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
_CSRC = _PKG / "csrc"
_SOURCES = (_CSRC / "ntt_fused.cu", _CSRC / "ntt_fused64.cu",
            _CSRC / "dft_mxu64.cu", _CSRC / "ntt_butterfly.cu",
            _CSRC / "lwe_chain.cu")
_HEADERS = (_CSRC / "digit_matmul64.cuh", _CSRC / "ntt_butterfly.cuh")
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


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
        lib.nfl_ntt_fused64.argtypes = [i32, i32] + [ptr] * 12 \
            + [i32] * 4 + [ptr]
        lib.nfl_ntt_fused64.restype = i32
        lib.nfl_dft_mxu64.argtypes = [i32] + [ptr] * 5 + [i32] * 5 + [ptr]
        lib.nfl_dft_mxu64.restype = i32
        lib.nfl_ntt_butterfly.argtypes = [i32] * 4 + [ptr] * 7 + [i32] * 3 \
            + [ptr]
        lib.nfl_ntt_butterfly.restype = i32
        lib.nfl_lwe_encrypt.argtypes = [i32] + [ptr] * 14 + [i32] * 3 + [ptr]
        lib.nfl_lwe_encrypt.restype = i32
        lib.nfl_lwe_decrypt.argtypes = [i32] + [ptr] * 10 + [i32] * 3 + [ptr]
        lib.nfl_lwe_decrypt.restype = i32
        lib.nfl_cuda_error_string.argtypes = [i32]
        lib.nfl_cuda_error_string.restype = ctypes.c_char_p
        self.lib = lib

    def check(self, err: int, what: str) -> None:
        if err != 0:
            msg = self.lib.nfl_cuda_error_string(err).decode()
            raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def _run_all(cmds):
    """Run the commands as parallel processes; (ok, combined output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    bad = [(c, o) for c, p, o in zip(cmds, procs, outs) if p.returncode]
    log = "".join(outs)
    if bad:
        raise RuntimeError("nfllib_tpu_torch: kernel build failed:\n" + "".join(
            f"{' '.join(c)}\n{o}" for c, o in bad))
    return log


@functools.lru_cache(maxsize=1)
def library() -> Library:
    """Build (once per source hash) and load the kernel library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    path = _BUILD_DIR / f"libnfl_kernels_{h.hexdigest()[:16]}.so"
    if path.exists():
        return Library(path, 0.0, "")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in _SOURCES]
    t0 = time.perf_counter()
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(_SOURCES, objs)])
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    os.replace(tmp, path)
    return Library(path, seconds, log)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class _Wrapper:
    """One kernel entry point with its launch count: `launches` grows by one
    for each launch and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def _check(self, ok: bool, x: torch.Tensor, tables, want: str) -> None:
        if not ok:
            raise ValueError(f"{self.name}: expected {want}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        if tables.device != x.device:
            raise ValueError(f"{self.name}: tables on {tables.device}, "
                             f"data on {x.device}")

    def _launch(self, x: torch.Tensor, entry: str, *args) -> None:
        """Call the C entry point on x's device and PyTorch's current stream;
        a CUDA error raises, a launch counts."""
        lib = library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib.lib, entry)(*args, ctypes.c_void_p(stream))
        lib.check(err, self.name)
        self.launches += 1


class FusedNttKernel(_Wrapper):
    """Wrapper of one direction of csrc/ntt_fused.cu (K1 / K2)."""

    def __init__(self, name: str, inverse: bool):
        super().__init__(name)
        self.inverse = inverse

    def __call__(self, x: torch.Tensor, tables, strict: bool) -> torch.Tensor:
        """x: contiguous CUDA [B, m, n] int32 (u32) / int16 (u16) residues
        -> new tensor of the same shape."""
        m, n1, n2 = tables.m, tables.n1, tables.n2
        want = torch.int16 if tables.ndig == 2 else torch.int32
        self._check(x.is_cuda and x.dtype == want and x.dim() == 3
                    and x.shape[1:] == (m, n1 * n2) and x.is_contiguous(),
                    x, tables, f"a contiguous CUDA {want} tensor "
                    f"[B, {m}, {n1 * n2}]")
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        self._launch(
            x, "nfl_ntt_fused", int(self.inverse), int(tables.ndig == 2),
            int(strict), _ptr(x), _ptr(out), _ptr(tables.w1), _ptr(tables.w2),
            _ptr(tables.tw), _ptr(tables.tws), _ptr(tables.corr1),
            _ptr(tables.corr2), _ptr(tables.p), _ptr(tables.mbar),
            x.shape[0], m, n1, n2)
        return out


class FusedNtt64Kernel(_Wrapper):
    """Wrapper of one direction of csrc/ntt_fused64.cu (K4): one count for
    each transform launched (its two passes, and the poison pass in strict
    mode)."""

    def __init__(self, name: str, inverse: bool):
        super().__init__(name)
        self.inverse = inverse

    def __call__(self, x: torch.Tensor, tables, strict: bool) -> torch.Tensor:
        """x: contiguous CUDA [B, m, n] int64 u64 residues -> new tensor of
        the same shape."""
        m, n1, n2 = tables.m, tables.n1, tables.n2
        self._check(x.is_cuda and x.dtype == torch.int64 and x.dim() == 3
                    and x.shape[1:] == (m, n1 * n2) and x.is_contiguous(),
                    x, tables, f"a contiguous CUDA int64 tensor "
                    f"[B, {m}, {n1 * n2}]")
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        scratch = torch.empty_like(x)
        flags = torch.zeros(x.shape[0] * m, dtype=torch.int32,
                            device=x.device)
        self._launch(
            x, "nfl_ntt_fused64", int(self.inverse), int(strict), _ptr(x),
            _ptr(out), _ptr(scratch), _ptr(flags), _ptr(tables.w1),
            _ptr(tables.w2), _ptr(tables.tw), _ptr(tables.tws),
            _ptr(tables.corr1), _ptr(tables.corr2), _ptr(tables.p),
            _ptr(tables.mbar), x.shape[0], m, n1, n2)
        return out


class DftMxu64Kernel(_Wrapper):
    """Wrapper of csrc/dft_mxu64.cu (K5)."""

    def __call__(self, x: torch.Tensor, tables) -> torch.Tensor:
        """x: contiguous CUDA [B, m, r, c] int64 u64 residues, r (left) or
        c (right) equal to tables.size -> new tensor of the same shape."""
        size, m = tables.size, tables.m
        self._check(x.is_cuda and x.dtype == torch.int64 and x.dim() == 4
                    and x.shape[1] == m and x.is_contiguous()
                    and x.shape[2 if tables.left else 3] == size,
                    x, tables, f"a contiguous CUDA int64 tensor [B, {m}, r, "
                    f"c] with {size} {'rows' if tables.left else 'columns'}")
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        self._launch(
            x, "nfl_dft_mxu64", int(tables.left), _ptr(x), _ptr(out),
            _ptr(tables.planes), _ptr(tables.corr), _ptr(tables.consts),
            int(tables.bias), x.shape[0], m, x.shape[2], x.shape[3])
        return out


class _ButterflyWrapper(_Wrapper):
    """Common checks of the butterfly NTT and LWE chain wrappers: each
    serves the limbs `limbs` and takes [B, m, n] tensors in the ring's
    storage dtype, with the tables of ops/ntt_pallas.py:kernel_tables."""

    def __init__(self, name: str, limbs: tuple):
        super().__init__(name)
        self.limbs = limbs

    def _check_all(self, tables, shape, *xs) -> None:
        if tables.limb not in self.limbs:
            raise ValueError(f"{self.name}: serves {self.limbs}, not "
                             f"{tables.limb}")
        want = tables.p.dtype
        for x in xs:
            self._check(x.is_cuda and x.dtype == want and x.is_contiguous()
                        and tuple(x.shape) == shape, x, tables,
                        f"a contiguous CUDA {want} tensor {shape}")


class ButterflyNttKernel(_ButterflyWrapper):
    """Wrapper of one direction of csrc/ntt_butterfly.cu (K3 for u16/u32,
    K7 for u64)."""

    def __init__(self, name: str, inverse: bool, limbs: tuple):
        super().__init__(name, limbs)
        self.inverse = inverse

    def __call__(self, x: torch.Tensor, tables, *, twist: bool,
                 strict: bool, inverse_tables: bool = False) -> torch.Tensor:
        """x: contiguous CUDA [B, m, n] residues -> new tensor of the same
        shape.  Forward: the phi^i pre-twist if `twist`, the omega^-1
        tables if `inverse_tables`.  Inverse: stage inversion, the
        n^-1 phi^-i untwist if `twist`."""
        self._check_all(tables, (x.shape[0], tables.m, tables.n), x)
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        inv_tabs = self.inverse or inverse_tables
        w, ws = (tables.iw, tables.iws) if inv_tabs else (tables.w, tables.ws)
        tw, tws = (tables.itw, tables.itws) if self.inverse \
            else (tables.tw, tables.tws)
        self._launch(x, "nfl_ntt_butterfly", tables.bits, int(self.inverse),
                     int(twist), int(strict), _ptr(x), _ptr(out), _ptr(w),
                     _ptr(ws), _ptr(tw), _ptr(tws), _ptr(tables.p),
                     x.shape[0], tables.m, tables.log_n)
        return out


class LweEncryptKernel(_ButterflyWrapper):
    """Wrapper of nfl_lwe_encrypt in csrc/lwe_chain.cu (K6 for u16/u32,
    K8 for u64)."""

    def __call__(self, u, e1, e2, pka, pkb, tables):
        """u/e1/e2: contiguous CUDA [B, m, n]; pka/pkb: [m, n] ->
        (resa, resb), each [B, m, n]."""
        m, n = tables.m, tables.n
        self._check_all(tables, (u.shape[0], m, n), u, e1, e2)
        self._check_all(tables, (m, n), pka, pkb)
        resa, resb = torch.empty_like(u), torch.empty_like(u)
        if u.shape[0] == 0:
            return resa, resb
        scratch = torch.empty_like(u) if tables.global_stages else None
        self._launch(u, "nfl_lwe_encrypt", tables.bits, _ptr(u), _ptr(e1),
                     _ptr(e2), _ptr(pka), _ptr(pkb), _ptr(resa), _ptr(resb),
                     ctypes.c_void_p(None if scratch is None
                                     else scratch.data_ptr()),
                     _ptr(tables.w), _ptr(tables.ws), _ptr(tables.tw),
                     _ptr(tables.tws), _ptr(tables.p), _ptr(tables.pn),
                     u.shape[0], m, tables.log_n)
        return resa, resb


class LweDecryptKernel(_ButterflyWrapper):
    """Wrapper of nfl_lwe_decrypt in csrc/lwe_chain.cu (K6 for u16/u32,
    K8 for u64)."""

    def __call__(self, resa, resb, s, sprime, tables):
        """resa/resb: contiguous CUDA [B, m, n]; s/sprime: [m, n] -> the
        coefficient-domain [B, m, n]."""
        m, n = tables.m, tables.n
        self._check_all(tables, (resa.shape[0], m, n), resa, resb)
        self._check_all(tables, (m, n), s, sprime)
        out = torch.empty_like(resa)
        if resa.shape[0] == 0:
            return out
        self._launch(resa, "nfl_lwe_decrypt", tables.bits, _ptr(resa),
                     _ptr(resb), _ptr(s), _ptr(sprime), _ptr(out),
                     _ptr(tables.iw), _ptr(tables.iws), _ptr(tables.itw),
                     _ptr(tables.itws), _ptr(tables.p), resa.shape[0], m,
                     tables.log_n)
        return out


NTT_FUSED_FWD = FusedNttKernel("ntt_fused_fwd", inverse=False)
NTT_FUSED_INV = FusedNttKernel("ntt_fused_inv", inverse=True)
NTT_FUSED64_FWD = FusedNtt64Kernel("ntt_fused64_fwd", inverse=False)
NTT_FUSED64_INV = FusedNtt64Kernel("ntt_fused64_inv", inverse=True)
DFT_MXU64 = DftMxu64Kernel("dft_mxu64")
_NARROW, _U64 = ("u16", "u32"), ("u64",)
NTT_BUTTERFLY_FWD = ButterflyNttKernel("ntt_butterfly_fwd", False, _NARROW)
NTT_BUTTERFLY_INV = ButterflyNttKernel("ntt_butterfly_inv", True, _NARROW)
NTT_BUTTERFLY64_FWD = ButterflyNttKernel("ntt_butterfly64_fwd", False, _U64)
NTT_BUTTERFLY64_INV = ButterflyNttKernel("ntt_butterfly64_inv", True, _U64)
LWE_ENCRYPT = LweEncryptKernel("lwe_encrypt", _NARROW)
LWE_DECRYPT = LweDecryptKernel("lwe_decrypt", _NARROW)
LWE64_ENCRYPT = LweEncryptKernel("lwe64_encrypt", _U64)
LWE64_DECRYPT = LweDecryptKernel("lwe64_decrypt", _U64)
KERNELS = (NTT_FUSED_FWD, NTT_FUSED_INV, NTT_FUSED64_FWD, NTT_FUSED64_INV,
           DFT_MXU64, NTT_BUTTERFLY_FWD, NTT_BUTTERFLY_INV,
           NTT_BUTTERFLY64_FWD, NTT_BUTTERFLY64_INV, LWE_ENCRYPT,
           LWE_DECRYPT, LWE64_ENCRYPT, LWE64_DECRYPT)
