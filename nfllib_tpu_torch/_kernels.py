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
_SOURCES = (_CSRC / "dft_mxu64.cu", _CSRC / "dft_mxu32.cu",
            _CSRC / "dft_mxu64_pipe.cu", _CSRC / "pair_bridge.cu",
            _CSRC / "ntt_butterfly.cu", _CSRC / "lwe_chain.cu")
_HEADERS = (_CSRC / "dft_stage.cuh", _CSRC / "digit_mma.cuh",
            _CSRC / "ntt_butterfly.cuh")
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
        for entry in ("nfl_dft_mxu64", "nfl_dft_mxu32",
                      "nfl_dft_mxu32_small_p", "nfl_dft_mxu64_pipe"):
            fn = getattr(lib, entry)
            fn.argtypes = [i32] + [ptr] * 9 + [i32] * 5 + [ptr]
            fn.restype = i32
        lib.nfl_pair_bridge64.argtypes = [ptr] * 5 + [i32, i32,
                                                      ctypes.c_longlong, ptr]
        lib.nfl_pair_bridge64.restype = i32
        lib.nfl_ntt_butterfly.argtypes = [i32] * 4 + [ptr] * 5 + [i32] * 3 \
            + [ptr]
        lib.nfl_ntt_butterfly.restype = i32
        lib.nfl_lwe_encrypt.argtypes = [i32] + [ptr] * 12 + [i32] * 3 + [ptr]
        lib.nfl_lwe_encrypt.restype = i32
        lib.nfl_lwe_decrypt.argtypes = [i32] + [ptr] * 8 + [i32] * 3 + [ptr]
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


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


# The most polynomials one launch takes: the kernels below put the batch on
# grid.z (at most 65535), so the wrappers launch a larger batch in chunks
# along its leading axis; every kernel treats polynomials independently.
MAX_BATCH = 65535


def batch_chunks(batch: int) -> list:
    """[start, stop) ranges of at most MAX_BATCH polynomials covering
    range(batch) in order."""
    return [(s, min(s + MAX_BATCH, batch))
            for s in range(0, batch, MAX_BATCH)]


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

    def _launch_chunks(self, batched, entry: str, args) -> None:
        """_launch(entry, *args(*chunks, n)) once for each chunk of at most
        MAX_BATCH polynomials of the leading axis: `batched` are the tensors
        with that axis (None passes as None), n the chunk's polynomials.
        Each chunk counts as one launch."""
        for s, e in batch_chunks(batched[0].shape[0]):
            self._launch(batched[0], entry, *args(
                *(None if t is None else t[s:e] for t in batched), e - s))


class DftMxuKernel(_Wrapper):
    """Wrapper of one square mod-matmul kernel: csrc/dft_mxu64.cu (K5,
    without and with the twiddle epilogue, one wrapper each; two launches
    of it are the u64 NTT, K4), dft_mxu32.cu (K9; two launches of it are
    the u16/u32 NTT, K1/K2) or dft_mxu64_pipe.cu (K10).  The kernels take
    the tables' K-major operand planes (`DftTables.mma_planes`, ndig of
    them: 8 for u64, 4 for u32 words) and a
    scratch this wrapper allocates for each call with torch.empty: int8
    [B, m, ndig, kp / 32, other, 32] (other = c for left, r for right; kp =
    max(size, 32)), into which the kernel's prologue writes x's offset-byte
    planes K-major in k-chunks of 32, as mma_planes; prologue, products and
    (strict mode) poison pass count as one launch a chunk of polynomials.
    Tables with `small_p` (u16 rings) go to `small_p_entry`, the kernel's
    instances with the small-p finish."""

    def __init__(self, name: str, entry: str, ndig: int, twiddle,
                 small_p_entry: str | None = None):
        super().__init__(name)
        self.entry = entry
        self.small_p_entry = small_p_entry
        self.ndig = ndig
        self.twiddle = twiddle      # True / False: required / refused; None

    def __call__(self, x: torch.Tensor, tables, twiddle=None,
                 strict: bool = False) -> torch.Tensor:
        """x: contiguous CUDA [B, m, r, c] residues (int64 u64 words for 8
        digits, int32 u32 words for 4), r (left) or c (right) equal to
        tables.size; twiddle=(tw, tws): contiguous [m, r, c] in x's dtype;
        strict: an input not below p or an output that breaks the stage
        contract poisons its (polynomial, channel) slab with all-ones words
        -> new tensor of x's shape."""
        size, m = tables.size, tables.m
        want = torch.int64 if self.ndig == 8 else torch.int32
        self._check(x.is_cuda and x.dtype == want and x.dim() == 4
                    and x.shape[1] == m and x.is_contiguous()
                    and tables.ndig == self.ndig
                    and (self.small_p_entry is not None or not tables.small_p)
                    and x.shape[2 if tables.left else 3] == size,
                    x, tables, f"a contiguous CUDA {want} tensor [B, {m}, r, "
                    f"c] with {size} {'rows' if tables.left else 'columns'}")
        if self.twiddle is not None and (twiddle is not None) != self.twiddle:
            raise ValueError(f"{self.name}: twiddle= is "
                             f"{'required' if self.twiddle else 'refused'}")
        tw = tws = None
        if twiddle is not None:
            for t in twiddle:
                self._check(t.is_cuda and t.dtype == want and t.is_contiguous()
                            and tuple(t.shape) == tuple(x.shape[1:]), t,
                            tables, f"a contiguous CUDA {want} twiddle "
                            f"{tuple(x.shape[1:])}")
            tw, tws = twiddle
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        table = tables.mma_planes            # [m, ndig, chunks, size, kc]
        other = x.shape[3 if tables.left else 2]
        scratch = torch.empty((x.shape[0], m) + tuple(table.shape[1:3])
                              + (other, table.shape[4]), dtype=torch.int8,
                              device=x.device)
        flags = torch.zeros((x.shape[0], m), dtype=torch.int32,
                            device=x.device) if strict else None
        self._launch_chunks(
            (x, out, scratch, flags),
            self.small_p_entry if tables.small_p else self.entry,
            lambda xc, oc, sc, fc, nb: (
                int(tables.left), _ptr(xc), _ptr(oc), _ptr(table),
                _ptr(tables.corr), _ptr(tables.consts), _ptr(tw), _ptr(tws),
                _ptr(sc), _ptr(fc), int(tables.bias), nb, m, x.shape[2],
                x.shape[3]))
        return out


class PairBridgeKernel(_Wrapper):
    """Wrapper of csrc/pair_bridge.cu (K11)."""

    def __call__(self, x: torch.Tensor, tw: torch.Tensor, tws: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
        """x: contiguous CUDA [B, m, R, C] int64 u64 residues; tw/tws:
        [m, R, C]; p: [m] -> canonical x * tw mod p, a new tensor."""
        m = p.shape[0]
        for t, shape in ((x, (x.shape[0], m) + tuple(x.shape[2:])),
                         (tw, tuple(x.shape[1:])), (tws, tuple(x.shape[1:])),
                         (p, (m,))):
            self._check(t.is_cuda and t.dtype == torch.int64 and x.dim() == 4
                        and t.is_contiguous() and tuple(t.shape) == shape,
                        t, x, f"a contiguous CUDA int64 tensor {shape}")
        out = torch.empty_like(x)
        if x.shape[0] == 0:
            return out
        self._launch(x, "nfl_pair_bridge64", _ptr(x), _ptr(out), _ptr(tw),
                     _ptr(tws), _ptr(p), x.shape[0], m,
                     ctypes.c_longlong(x.shape[2] * x.shape[3]))
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
        wp = tables.iwp if self.inverse or inverse_tables else tables.wp
        twp = tables.itwp if self.inverse else tables.twp
        self._launch_chunks(
            (x, out), "nfl_ntt_butterfly",
            lambda xc, oc, nb: (
                tables.bits, int(self.inverse), int(twist), int(strict),
                _ptr(xc), _ptr(oc), _ptr(wp), _ptr(twp), _ptr(tables.p), nb,
                tables.m, tables.log_n))
        return out


class LweEncryptKernel(_ButterflyWrapper):
    """Wrapper of nfl_lwe_encrypt in csrc/lwe_chain.cu (K6 for u16/u32,
    K8 for u64): one kernel launch a chunk where the polynomial fits a
    block (u16/u32, u64 up to 2^14); above, u64 runs each input's leading
    stages first, into resa, resb and a scratch this wrapper allocates."""

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
        self._launch_chunks(
            (u, e1, e2, resa, resb, scratch), "nfl_lwe_encrypt",
            lambda uc, e1c, e2c, rac, rbc, sc, nb: (
                tables.bits, _ptr(uc), _ptr(e1c), _ptr(e2c), _ptr(pka),
                _ptr(pkb), _ptr(rac), _ptr(rbc), _ptr(sc), _ptr(tables.wp),
                _ptr(tables.twp), _ptr(tables.p),
                _ptr(tables.pn if tables.limb == "u64" else tables.bm), nb, m,
                tables.log_n))
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
        self._launch_chunks(
            (resa, resb, out), "nfl_lwe_decrypt",
            lambda rac, rbc, oc, nb: (
                tables.bits, _ptr(rac), _ptr(rbc), _ptr(s), _ptr(sprime),
                _ptr(oc), _ptr(tables.iwp), _ptr(tables.itwp),
                _ptr(tables.p), nb, m, tables.log_n))
        return out


DFT_MXU64 = DftMxuKernel("dft_mxu64", "nfl_dft_mxu64", 8, twiddle=False)
DFT_MXU64_TW = DftMxuKernel("dft_mxu64_twiddle", "nfl_dft_mxu64", 8,
                            twiddle=True)
DFT_MXU32 = DftMxuKernel("dft_mxu32", "nfl_dft_mxu32", 4, twiddle=None,
                         small_p_entry="nfl_dft_mxu32_small_p")
DFT_MXU64_PIPE = DftMxuKernel("dft_mxu64_pipe", "nfl_dft_mxu64_pipe", 8,
                              twiddle=None)
PAIR_BRIDGE64 = PairBridgeKernel("pair_bridge64")
_NARROW, _U64 = ("u16", "u32"), ("u64",)
NTT_BUTTERFLY_FWD = ButterflyNttKernel("ntt_butterfly_fwd", False, _NARROW)
NTT_BUTTERFLY_INV = ButterflyNttKernel("ntt_butterfly_inv", True, _NARROW)
NTT_BUTTERFLY64_FWD = ButterflyNttKernel("ntt_butterfly64_fwd", False, _U64)
NTT_BUTTERFLY64_INV = ButterflyNttKernel("ntt_butterfly64_inv", True, _U64)
LWE_ENCRYPT = LweEncryptKernel("lwe_encrypt", _NARROW)
LWE_DECRYPT = LweDecryptKernel("lwe_decrypt", _NARROW)
LWE64_ENCRYPT = LweEncryptKernel("lwe64_encrypt", _U64)
LWE64_DECRYPT = LweDecryptKernel("lwe64_decrypt", _U64)
KERNELS = (DFT_MXU64, DFT_MXU64_TW, DFT_MXU32, DFT_MXU64_PIPE, PAIR_BRIDGE64,
           NTT_BUTTERFLY_FWD, NTT_BUTTERFLY_INV, NTT_BUTTERFLY64_FWD,
           NTT_BUTTERFLY64_INV, LWE_ENCRYPT, LWE_DECRYPT, LWE64_ENCRYPT,
           LWE64_DECRYPT)
