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
import math
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_SOURCES = (_CSRC / "dft_mxu64.cu", _CSRC / "dft_mxu32.cu",
            _CSRC / "dft_mxu64_pipe.cu", _CSRC / "ntt_butterfly.cu",
            _CSRC / "lwe_chain.cu", _CSRC / "salsa20.cu",
            _CSRC / "gaussian_fixed.cu", _CSRC / "gaussian_exact.cu",
            _CSRC / "modops_expr.cu", _CSRC / "hwt.cu")
_HEADERS = (_CSRC / "dft_stage.cuh", _CSRC / "digit_mma.cuh",
            _CSRC / "ntt_butterfly.cuh", _CSRC / "salsa20_block.cuh",
            _CSRC / "gaussian_search.cuh", _CSRC / "launch.cuh")
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
        lib.nfl_ntt_butterfly.argtypes = [i32] * 4 + [ptr] * 5 + [i32] * 3 \
            + [ptr]
        lib.nfl_ntt_butterfly.restype = i32
        lib.nfl_lwe_encrypt.argtypes = [i32] + [ptr] * 12 + [i32] * 3 + [ptr]
        lib.nfl_lwe_encrypt.restype = i32
        lib.nfl_lwe_decrypt.argtypes = [i32] + [ptr] * 8 + [i32] * 3 + [ptr]
        lib.nfl_lwe_decrypt.restype = i32
        lib.nfl_salsa20.argtypes = [ptr, ptr, ctypes.c_ulonglong, ptr, i32,
                                    ctypes.c_longlong, ptr, ptr]
        lib.nfl_salsa20.restype = i32
        lib.nfl_salsa20_sampler.argtypes = SALSA20_SAMPLER_ARGTYPES
        lib.nfl_salsa20_sampler.restype = i32
        i64 = ctypes.c_longlong
        lib.nfl_gaussian_fixed.argtypes = [
            ptr, ptr, ctypes.c_ulonglong, ptr, ptr, i32, i32, i32, i32, ptr,
            i32, i32, ptr, i32, i32, ptr, ptr]
        lib.nfl_gaussian_fixed.restype = i32
        lib.nfl_gaussian_exact_plan.argtypes = [i32] * 6 + [i64, ptr]
        lib.nfl_gaussian_exact_plan.restype = None
        lib.nfl_gaussian_exact.argtypes = [ptr, ptr, ctypes.c_ulonglong] \
            + [i32] * 6 + [ptr] * 6 + [i32, i32, i64, ptr, i32, i32] \
            + [ptr] * 3 + [i64, ptr]
        lib.nfl_gaussian_exact.restype = i32
        lib.nfl_modops_expr.argtypes = MODOPS_EXPR_ARGTYPES
        lib.nfl_modops_expr.restype = i32
        set_hwt_argtypes(lib)
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
        """Call the C entry point on x's device and PyTorch's current stream,
        under a device guard only when that device is not the current one;
        a CUDA error raises, a launch counts."""
        lib = library()
        index = x.device.index
        if index == torch.cuda.current_device():
            stream = torch.cuda.current_stream(index).cuda_stream
            err = getattr(lib.lib, entry)(*args, ctypes.c_void_p(stream))
        else:
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


def _nonce_args(name: str, nonce, device) -> tuple:
    """(device int64 or None, host addend) for a kernel's nonce: a Python
    int (the addend, mod 2^64) or a 0-d int64 tensor on `device`, which
    the host never reads."""
    if isinstance(nonce, torch.Tensor):
        if not (nonce.device == device and nonce.dtype == torch.int64
                and nonce.numel() == 1 and nonce.is_contiguous()):
            raise ValueError(f"{name}: a tensor nonce must be one int64 on "
                             f"{device}, got {nonce.dtype} "
                             f"{tuple(nonce.shape)} on {nonce.device}")
        return nonce, 0
    return None, int(nonce) & ((1 << 64) - 1)


@functools.lru_cache(maxsize=64)
def _key_words(key: bytes):
    """a key's 8 little-endian words as the kernels take them, built once a
    key"""
    return (ctypes.c_uint32 * 8)(*np.frombuffer(key, dtype="<u4"))


class Salsa20Kernel(_Wrapper):
    """Wrapper of csrc/salsa20.cu's raw keystream (S1, in place of the XLA
    code of nfllib_tpu/prng/salsa20.py:device_stream_words): every
    keystream of a call in one launch (prng.device_stream_words,
    salsa20.keystream)."""

    def __call__(self, key: bytes, nonce, nblocks: int, fills: int,
                 device) -> torch.Tensor:
        """The first `nblocks` blocks of the streams at nonces nonce + f,
        f < fills, mod 2^64 -> int32 [fills, nblocks * 16] on `device`
        (uint32 words).  nonce: a Python int, or a 0-d int64 tensor on
        `device` that is never read on the host."""
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"{self.name}: expected a CUDA device, got "
                             f"{device}")
        out = torch.empty((fills, nblocks * 16), dtype=torch.int32,
                          device=device)
        nonce_t, nonce_add = _nonce_args(self.name, nonce, out.device)
        if fills == 0 or nblocks == 0:
            return out
        self._launch(out, "nfl_salsa20", _key_words(key), _ptr(nonce_t),
                     ctypes.c_ulonglong(nonce_add), None, fills,
                     ctypes.c_longlong(nblocks), _ptr(out))
        return out


# nfl_salsa20_sampler(epi, bytes, key, nonce_dev, nonce_add, p, m, log_n,
# offset, c0, c1, c2, c3, out, device, stream)
SALSA20_SAMPLER_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                            ctypes.c_void_p, ctypes.c_ulonglong,
                            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong] \
    + [ctypes.c_ulonglong] * 4 + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p]


class Salsa20SamplerKernel(_Wrapper):
    """Wrapper of one sampler instance of csrc/salsa20.cu (S1 with the
    epilogue of device_uniform, device_non_uniform or device_zo, in place
    of the XLA programs of nfllib_tpu/prng/device_sampling.py:65, :78 and
    :101): the keystream and its residues in one launch, nothing else on
    the card."""

    _EPI = {"uniform": 1, "non_uniform": 2, "zo": 3}
    _BYTES = {torch.int16: 2, torch.int32: 4, torch.int64: 8}
    _M64 = (1 << 64) - 1

    def __init__(self, name: str, epilogue: str):
        super().__init__(name)
        self.epi = self._EPI[epilogue]

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def __call__(self, key: bytes, nonce, p: torch.Tensor, n: int,
                 dtype: torch.dtype, *consts: int,
                 offset: int = 0) -> torch.Tensor:
        """The sampler's [m, n] residues in `dtype` (the ring's storage) on
        p's device from the stream at `nonce` (a Python int, or a 0-d
        int64 tensor on that device, never read on the host).  p: the
        ring's contiguous int64 moduli, [m] or [m, 1]; n: the degree, a
        power of two; consts: the epilogue's words (uniform: the modulus
        mask; non-uniform: the mask, span, ub and amplifier; ZO: rho),
        each taken mod 2^64; offset: the uniform's first stream limb
        (first * n on a channel block, whose rows are then the whole
        ring's), 0 for the others."""
        nbytes = self._BYTES.get(dtype)
        m = p.shape[0]
        if not (self._on_card(p) and p.dtype == torch.int64
                and p.is_contiguous() and p.numel() == m and nbytes
                and n > 0 and n & (n - 1) == 0 and len(key) == 32
                and len(consts) <= 4):
            raise ValueError(f"{self.name}: expected contiguous int64 moduli "
                             f"on the card, a power-of-two degree, a "
                             f"storage dtype and a 32-byte key, got "
                             f"{p.dtype} {tuple(p.shape)} on {p.device}, "
                             f"n={n}, {dtype}")
        if offset < 0 or (offset and self.epi != self._EPI["uniform"]):
            raise ValueError(f"{self.name}: a stream offset is the uniform "
                             f"sampler's, and not negative; got {offset}")
        nonce_t, nonce_add = _nonce_args(self.name, nonce, p.device)
        out = torch.empty((m, n), dtype=dtype, device=p.device)
        c = [v & self._M64 for v in consts] + [0] * (4 - len(consts))
        self._launch(out, "nfl_salsa20_sampler", self.epi, nbytes,
                     _key_words(key), None if nonce_t is None
                     else nonce_t.data_ptr(), nonce_add, p.data_ptr(), m,
                     n.bit_length() - 1, offset, *c, out.data_ptr(),
                     out.device.index or 0)
        return out


# A block's shared memory on the cards the kernels are built for (sm_90:
# 227 KB with the opt-in), S4's bound between its two instances.
SHARED_MEMORY_OPTIN = 232448


# nfl_hwt_state_bytes(); nfl_hwt_plan(exact, n, h, words_in, cap, out);
# nfl_hwt_exact(key, nonce_dev, nonce_add, words, n, h, amb_cap, p, m,
# out_bytes, out, adv, scratch, state, cap, device, stream);
# nfl_hwt_fixed(key, nonce_dev, nonce_add, words, n, h, p, m, out_bytes,
# out, scratch, state, cap, device, stream)
def set_hwt_argtypes(lib) -> None:
    """csrc/hwt.cu's entry points' ctypes signatures, on `lib`"""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.nfl_hwt_state_bytes.argtypes = []
    lib.nfl_hwt_state_bytes.restype = i64
    lib.nfl_hwt_plan.argtypes = [i32] * 4 + [i64, ptr]
    lib.nfl_hwt_plan.restype = None
    lib.nfl_hwt_exact.argtypes = [ptr, ptr, ctypes.c_ulonglong, ptr] \
        + [i32] * 3 + [ptr] + [i32] * 2 + [ptr] * 4 + [i64, i32, ptr]
    lib.nfl_hwt_exact.restype = i32
    lib.nfl_hwt_fixed.argtypes = [ptr, ptr, ctypes.c_ulonglong, ptr] \
        + [i32] * 2 + [ptr] + [i32] * 2 + [ptr] * 3 + [i64, i32, ptr]
    lib.nfl_hwt_fixed.restype = i32


# S6's fast instance takes h up to this (its reservoir is a stream's
# persistent words); a larger h runs the many-block walk
HWT_PARTIAL_MAX_H = 8192
# S5's last CTA selects among at most this many candidates in shared memory
# (16 bytes each); more (a large h), or too few, and it selects among all n
# keys in global memory
HWT_CAND_MAX = 2048


class HwtPlan(NamedTuple):
    """A call's plan (csrc/hwt.cu:nfl_hwt_plan): the fast instance (S6's
    persistent reservoir, S5's expected candidates within its cap),
    scratch bytes, CUDA kernels launched, the first launch's CTAs, and the
    byte offset in the scratch where they write their SM ids."""

    fast: bool
    bytes: int
    kernels: int
    grid: int
    smid: int


def _raw_stream(index: int) -> int:
    """the current CUDA stream of device `index` as an address (a Stream
    object costs microseconds)"""
    return torch._C._cuda_getCurrentRawStream(index)


class _HwtKernel(_Wrapper):
    """Common part of the hwt samplers' wrappers (csrc/hwt.cu): the checks,
    the plan (memoised per shape) and the launch on the stream's
    workspace.  A call's entry point launches two kernels (the first over
    many CTAs, whose last CTA merges their work, then the store), S6's
    many-block walk three; one launch here."""

    _BYTES = {torch.int16: 2, torch.int32: 4, torch.int64: 8}
    exact = False

    def __init__(self, name: str):
        super().__init__(name)
        self._plans = {}
        # each (device, stream)'s workspace: the persistent state (the
        # last-CTA ticket and S6's reservoir, zeroed once, left at 0 by
        # every launch) and the scratch, reused in stream order and grown
        # when a call needs more; the lock keeps a call's two launches
        # together on the stream when threads share it (ctypes releases
        # the interpreter lock during the call)
        self._ws = {}
        self._lock = threading.Lock()
        self._last = None       # (scratch, plan) of the last call

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def _entry(self, name: str):
        return getattr(library().lib, name)

    @functools.cached_property
    def state_bytes(self) -> int:
        """the bytes of a stream's persistent state"""
        return int(self._entry("nfl_hwt_state_bytes")())

    def plan(self, n: int, h: int, words_in: bool = False,
             cap=None) -> HwtPlan:
        """the plan of a call (memoised)"""
        key = (n, h, bool(words_in), self.CAP if cap is None else cap)
        pl = self._plans.get(key)
        if pl is None:
            out = (ctypes.c_longlong * 5)()
            self._entry("nfl_hwt_plan")(int(self.exact), n, h, key[2],
                                        key[3], out)
            pl = self._plans[key] = HwtPlan(bool(out[0]), *out[1:])
        return pl

    def _workspace(self, device, stream, nbytes: int):
        """(state, scratch) of (device, stream), the scratch at least
        nbytes"""
        ws = self._ws.get((device, stream))
        if ws is None or ws[1].numel() < nbytes:
            state = ws[0] if ws is not None else torch.zeros(
                self.state_bytes, dtype=torch.uint8, device=device)
            grown = max(nbytes, 2 * ws[1].numel() if ws is not None else 0)
            ws = self._ws[(device, stream)] = (state, torch.empty(
                grown, dtype=torch.uint8, device=device))
        return ws

    def last_sms(self) -> int:
        """the distinct SMs the last call's first launch ran on (reads the
        card; for checks, not the main path)"""
        scratch, pl = self._last
        return int(scratch[pl.smid:pl.smid + 4 * pl.grid].view(torch.int32)
                   .unique().numel())

    def _prepare(self, key, nonce, p, n, h, dtype, words, nwords, cap):
        """the checks -> (m, bytes a word, the nonce's args, the plan)"""
        nbytes = self._BYTES.get(dtype)
        m = p.shape[0]
        if not (self._on_card(p) and p.dtype == torch.int64
                and p.is_contiguous() and p.numel() == m and nbytes
                and 0 < n <= 1 << 20 and n & (n - 1) == 0 and 0 < h <= n
                and len(key) == 32):
            raise ValueError(f"{self.name}: expected contiguous int64 moduli "
                             f"on the card, a power-of-two degree up to "
                             f"2^20, 0 < h <= n, a storage dtype and a "
                             f"32-byte key, got {p.dtype} {tuple(p.shape)} "
                             f"on {p.device}, n={n}, h={h}, {dtype}")
        if words is not None and not (
                words.device == p.device and words.dtype == torch.int64
                and words.is_contiguous() and words.numel() == nwords):
            raise ValueError(f"{self.name}: words must be {nwords} "
                             f"contiguous int64 on {p.device}, got "
                             f"{words.dtype} {tuple(words.shape)} on "
                             f"{words.device}")
        nonce_args = _nonce_args(self.name, nonce, p.device)
        return m, nbytes, nonce_args, self.plan(n, h, words is not None, cap)

    def _run(self, p, entry, pl: HwtPlan, args) -> None:
        """Call the C entry point with args(state, scratch) and the stream,
        on p's device and its current stream's workspace; a CUDA error
        raises, a call counts one launch."""
        lib = library()
        index = p.device.index
        if index != torch.cuda.current_device():
            with torch.cuda.device(p.device):
                return self._run(p, entry, pl, args)
        stream = _raw_stream(index)
        with self._lock:
            state, scratch = self._workspace(p.device, stream, pl.bytes)
            err = getattr(lib.lib, entry)(
                *args(state.data_ptr(), scratch.data_ptr()), stream)
            self._last = (scratch, pl)
        lib.check(err, self.name)
        self.launches += 1


class HwtExactKernel(_HwtKernel):
    """Wrapper of S6, csrc/hwt.cu's stream-exact hwt sampler (in place of
    the XLA program of nfllib_tpu/prng/device_sampling.py:424
    device_hwt_exact): the host walk's reservoir, its signs and its nonce
    advance on the card, nothing read back."""

    exact = True
    CAP = HWT_PARTIAL_MAX_H
    MAX_AMB_CAP = 64

    def __call__(self, key: bytes, nonce, p: torch.Tensor, n: int, h: int,
                 dtype: torch.dtype, amb_cap: int = 8, words=None,
                 cap=None):
        """The [m, n] residues in `dtype` of sample_hwt(h) from the stream
        at `nonce` (a Python int, or a 0-d int64 tensor on p's device,
        never read on the host), and the nonce advance, a 0-d int64 on that
        device: the fills the host makes, plus one for the signs, or -1
        when the budget guard trips (more than amb_cap ambiguous words, or
        too few accepted ones), which makes every residue all ones.  p: the
        ring's int64 moduli [m] or [m, 1].  words: the words-in instance's
        reservoir words, int64 [nf * h] (nf = max(1, ceil((n - h) / h) +
        1)), in place of the keystream's; cap: the largest h of the
        persistent-reservoir instance (HWT_PARTIAL_MAX_H; 0: the
        many-block walk)."""
        if not 0 <= amb_cap <= self.MAX_AMB_CAP:
            raise ValueError(f"{self.name}: amb_cap {amb_cap} is not in "
                             f"[0, {self.MAX_AMB_CAP}]")
        nf = max(1, -(-(n - h) // h) + 1) if 0 < h else 0
        m, nbytes, (nonce_t, nonce_add), pl = self._prepare(
            key, nonce, p, n, h, dtype, words, nf * h, cap)
        out = torch.empty((m, n), dtype=dtype, device=p.device)
        adv = torch.empty((), dtype=torch.int64, device=p.device)
        self._run(p, "nfl_hwt_exact", pl, lambda state, scratch: (
            _key_words(key), _ptr(nonce_t), nonce_add, _ptr(words), n, h,
            amb_cap, p.data_ptr(), m, nbytes, out.data_ptr(), adv.data_ptr(),
            scratch, state, self.CAP if cap is None else cap,
            p.device.index or 0))
        return out, adv


class HwtFixedKernel(_HwtKernel):
    """Wrapper of S5, csrc/hwt.cu's fixed-consumption hwt sampler (in place
    of the XLA program of nfllib_tpu/prng/device_sampling.py:471
    device_hwt): the h smallest of n stream keys, selected among the keys
    at or below a threshold (or among all of them), and their signs, on
    the card."""

    CAP = HWT_CAND_MAX

    def __call__(self, key: bytes, nonce, p: torch.Tensor, n: int, h: int,
                 dtype: torch.dtype, words=None, cap=None) -> torch.Tensor:
        """The [m, n] residues in `dtype` of device_hwt(h) from the stream
        at `nonce` (a Python int, or a 0-d int64 tensor on p's device,
        never read on the host): hits at the first h indices of a stable
        argsort of the first n little-endian 64-bit words read as unsigned,
        the hit of rank j signed by bit 1 of word n + j.  words: the
        words-in instance's n keys, int64, in place of the keystream's
        (the signs stay the keystream's); cap: the most candidates the
        last CTA selects among in shared memory (HWT_CAND_MAX; 0: it
        always selects among all n keys)."""
        m, nbytes, (nonce_t, nonce_add), pl = self._prepare(
            key, nonce, p, n, h, dtype, words, n, cap)
        out = torch.empty((m, n), dtype=dtype, device=p.device)
        self._run(p, "nfl_hwt_fixed", pl, lambda state, scratch: (
            _key_words(key), _ptr(nonce_t), nonce_add, _ptr(words), n, h,
            p.data_ptr(), m, nbytes, out.data_ptr(), scratch, state,
            self.CAP if cap is None else cap, p.device.index or 0))
        return out


class _GaussianWrapper(_Wrapper):
    """Common checks of the device Gaussian kernels S3 and S4."""

    def _tables_and_p(self, barriers, wp, p, dtype):
        """the barrier table's and the moduli's checks -> p as [m]"""
        self._check(barriers.is_cuda and barriers.dtype == torch.int16
                    and barriers.dim() == 2 and barriers.shape[1] == wp
                    and barriers.is_contiguous(), barriers, barriers,
                    f"a contiguous CUDA int16 [nb, {wp}] barrier table")
        pp = p.reshape(-1)
        self._check(pp.dtype == torch.int64 and pp.is_contiguous()
                    and dtype in (torch.int16, torch.int32, torch.int64),
                    pp, barriers, "contiguous int64 moduli and a storage "
                    "dtype")
        return pp


class GaussianFixedKernel(_GaussianWrapper):
    """Wrapper of csrc/gaussian_fixed.cu (S3, in place of the XLA code of
    nfllib_tpu/prng/device_sampling.py:device_gaussian): F fixed-
    consumption Gaussians of one sampler in one launch, the keystream made
    in shared memory; F at most MAX_SAMPLERS (the kernel takes the
    offsets and amplifiers by value)."""

    MAX_SAMPLERS = 8

    def __call__(self, key: bytes, nonce, offsets, amps, n: int,
                 in_bits: int, wp: int, barriers: torch.Tensor, base: int,
                 p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Sampler f reads the stream at nonce + offsets[f] (mod 2^64),
        sample s its wp in_bits words from item s * wp, big-endian; ->
        [F, m, n] residues (base + #{barriers <= r}) * amps[f], encoded p
        + v when negative, in `dtype`.  barriers: int16 [nb, wp] (uint16
        words) on the card; p: int64 [m] or [m, 1]; nonce: a Python int or
        a 0-d int64 tensor on the card, never read on the host."""
        pp = self._tables_and_p(barriers, wp, p, dtype)
        f = len(offsets)
        self._check(in_bits in (8, 16) and len(amps) == f
                    and 0 < f <= self.MAX_SAMPLERS, barriers, barriers,
                    f"in_bits 8 or 16 and 1 to {self.MAX_SAMPLERS} samplers,"
                    f" one amplifier an offset")
        nonce_t, nonce_add = _nonce_args(self.name, nonce, barriers.device)
        m = pp.shape[0]
        out = torch.empty((f, m, n), dtype=dtype, device=barriers.device)
        if n == 0:
            return out
        # ctypes keeps the low 64 bits of each offset
        self._launch(barriers, "nfl_gaussian_fixed", _key_words(key),
                     _ptr(nonce_t), ctypes.c_ulonglong(nonce_add),
                     (ctypes.c_longlong * f)(*offsets),
                     (ctypes.c_longlong * f)(*amps), f, n, in_bits, wp,
                     _ptr(barriers), barriers.shape[0], int(base), _ptr(pp),
                     m, out.element_size(), _ptr(out))
        return out


class GaussianExactKernel(_GaussianWrapper):
    """Wrapper of csrc/gaussian_exact.cu (S4, in place of the XLA code of
    nfllib_tpu/prng/device_sampling.py:device_gaussian_exact): the
    stream-exact Gaussian.  Its entry point launches two kernels (the walk
    of every refill block, then the selection), one launch here; the
    scratch between them comes from torch.empty."""

    def plan(self, rlen: int, innoise: int, nblocks: int, in_bits: int,
             wp: int, nb: int, smem_cap: int = SHARED_MEMORY_OPTIN):
        """(walk in shared memory, its dynamic shared bytes, global
        scratch bytes) of a call"""
        out = (ctypes.c_longlong * 3)()
        library().lib.nfl_gaussian_exact_plan(rlen, innoise, nblocks,
                                              in_bits, wp, nb, smem_cap, out)
        return bool(out[0]), int(out[1]), int(out[2])

    def __call__(self, key: bytes, nonce, rlen: int, innoise: int,
                 nblocks: int, in_bits: int, wp: int, lu_depth: int, tables,
                 base: int, amp: int, p: torch.Tensor, dtype: torch.dtype):
        """The host walk's first rlen samples from fills of innoise words
        at nonce + k, k < nblocks (tables: device_sampling.gaussian_tables
        with exact=True, on the card) -> ([m, rlen] residues in `dtype`,
        int64 [2]: the host's fill count and nonce + that count, on the
        card).  nonce: a Python int or a 0-d int64 tensor on the card,
        never read on the host."""
        bw = tables.bw
        pp = self._tables_and_p(bw, wp, p, dtype)
        deep = lu_depth == 2
        for t in ((tables.luf, tables.luv)
                  + ((tables.slot, tables.V2, tables.F2) if deep else ())):
            self._check(t.is_cuda and t.device == bw.device
                        and t.is_contiguous(), t, bw,
                        "contiguous lookup tables on the barriers' device")
        self._check(in_bits in (8, 16) and lu_depth in (1, 2)
                    and innoise > 0 and rlen > 0 and nblocks > 0, bw, bw,
                    "in_bits 8 or 16, lu_depth 1 or 2, innoise > 0")
        nonce_t, nonce_add = _nonce_args(self.name, nonce, bw.device)
        m = pp.shape[0]
        out = torch.empty((m, rlen), dtype=dtype, device=bw.device)
        fills = torch.empty(2, dtype=torch.int64, device=bw.device)
        scratch = torch.empty(
            self.plan(rlen, innoise, nblocks, in_bits, wp, bw.shape[0])[2],
            dtype=torch.uint8, device=bw.device)
        self._launch(bw, "nfl_gaussian_exact", _key_words(key),
                     _ptr(nonce_t), ctypes.c_ulonglong(nonce_add), rlen,
                     innoise, nblocks, in_bits, wp, lu_depth,
                     _ptr(tables.luf), _ptr(tables.luv),
                     *(_ptr(t) if deep else None
                       for t in (getattr(tables, "slot", None),
                                 getattr(tables, "V2", None),
                                 getattr(tables, "F2", None))),
                     _ptr(bw), bw.shape[0], int(base),
                     ctypes.c_longlong(amp), _ptr(pp), m, out.element_size(),
                     _ptr(out), _ptr(fills), _ptr(scratch),
                     ctypes.c_longlong(SHARED_MEMORY_OPTIN))
        return out, fills


class ExprProgram(ctypes.Structure):
    """An elementwise program as csrc/modops_expr.cu's NflExprProgram
    takes it: up to kMaxInstr = 80 instructions of 6 bytes
    (ops/expr_program.py:Program.code) and the kMaxLeaves = 16 leaves'
    pointers, element counts and widths."""
    _fields_ = [("ninstr", ctypes.c_int32), ("nslots", ctypes.c_int32),
                ("nleaves", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("code", ctypes.c_ubyte * (6 * 80)),
                ("leaf", ctypes.c_void_p * 16),
                ("leaf_numel", ctypes.c_longlong * 16),
                ("leaf_bytes", ctypes.c_int32 * 16)]


# nfl_modops_expr(bits, program, out, consts, total, slab, m, device,
# instance out, stream)
MODOPS_EXPR_ARGTYPES = [ctypes.c_int, ctypes.POINTER(ExprProgram),
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]


class ModopsExprKernel(_Wrapper):
    """Wrapper of csrc/modops_expr.cu (E1, in place of the XLA programs of
    nfllib_tpu/poly.py:59 _jitted_impl and :320 _chain_program_impl): one
    elementwise program (ops/expr_program.py) over its leaves, one launch
    for fewer than MAX_ELEMENTS output elements, more launches in chunks
    of whole broadcast periods beyond.

    The C entry point chooses the kernel's instance from the shapes,
    pointers and program: 16-byte vector lanes where every pointer is
    16-byte aligned and the slab, the total and each leaf's element count
    are multiples of the lanes, else one word a step; a compiled instance
    for a one-node program over its leaves in order, else the interpreter.
    `last_instance` is ("named" or "tree", words a vector) of the last
    launch."""

    MAX_ELEMENTS = (1 << 31) - 1
    _BITS = {torch.int16: 16, torch.int32: 32, torch.int64: 64}

    def __init__(self, name: str):
        super().__init__(name)
        self.last_instance = None
        self._instance = ctypes.c_int(0)

    def _refuse(self, what: str):
        raise ValueError(f"{self.name}: {what}")

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def __call__(self, program, leaves, consts: torch.Tensor, shape,
                 channel_axis: int, dtype: torch.dtype) -> torch.Tensor:
        """leaves: CUDA tensors in `dtype` (the ring's storage; int64 too
        for u16/u32 tables) broadcasting to `shape`; a leaf that does not
        broadcast over leading dimensions only, or is not contiguous, is
        expanded to `shape` and made contiguous first.  consts: the ring's
        RingContext.to(device).expr_consts, [m, 4] with m = shape[
        channel_axis] -> a new tensor of `shape` in `dtype`."""
        shape = tuple(shape)
        bits = self._BITS.get(dtype)
        if bits is None or not shape:
            self._refuse(f"expected a storage dtype and a shape, got "
                         f"{dtype} {shape}")
        ax = channel_axis % len(shape)
        m, slab = shape[ax], math.prod(shape[ax + 1:])
        dev = consts.device
        if not (self._on_card(consts) and consts.dtype == torch.int64
                and consts.is_contiguous() and consts.shape == (m, 4)):
            self._refuse(f"expected contiguous CUDA int64 constants "
                         f"[{m}, 4], got {consts.dtype} "
                         f"{tuple(consts.shape)} on {consts.device}")
        if len(leaves) != program.nleaves:
            self._refuse(f"{program.nleaves} leaves, got {len(leaves)}")
        if not program.fits():
            self._refuse("a program past one launch's caps "
                         "(expr_program.MAX_NODES, MAX_LEAVES, MAX_SLOTS)")
        ready = []                    # (tensor, elements, bytes an element)
        for t in leaves:
            if not (t.device == dev and t.dtype in (dtype, torch.int64)):
                self._refuse(f"expected a {dtype} leaf on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
            inner = tuple(t.shape)
            while inner and inner[0] == 1:
                inner = inner[1:]
            if not (inner == shape[len(shape) - len(inner):]
                    and t.is_contiguous()):
                t = t.expand(shape).contiguous()
            ready.append((t, t.numel(), t.element_size()))
        out = torch.empty(shape, dtype=dtype, device=dev)
        total = out.numel()
        if total == 0:
            return out
        period = max([n for _, n, _ in ready if n < total] + [m * slab])
        step = self.MAX_ELEMENTS // period * period
        if step == 0:
            self._refuse(f"a broadcast period of {period} elements")
        instrs, nslots = program.code
        prog = ExprProgram(len(instrs), nslots, program.nleaves, 0)
        ctypes.memmove(prog.code, program.code_bytes,
                       len(program.code_bytes))
        ptrs = []
        for j, (t, n, size) in enumerate(ready):
            prog.leaf_bytes[j] = size
            prog.leaf_numel[j] = n
            prog.leaf[j] = ptr = t.data_ptr()
            ptrs.append(ptr)
        out_ptr, out_size = out.data_ptr(), out.element_size()
        for start in range(0, total, step):
            n = min(step, total - start)
            if step < total:          # chunks: the full leaves move along
                for j, (_, numel, size) in enumerate(ready):
                    if numel == total:
                        prog.leaf[j] = ptrs[j] + start * size
                        prog.leaf_numel[j] = n
            self._launch(out, "nfl_modops_expr", bits, ctypes.byref(prog),
                         out_ptr + start * out_size, consts.data_ptr(), n,
                         slab, m, dev.index or 0,
                         ctypes.byref(self._instance))
        v = self._instance.value
        self.last_instance = ("named" if v & 16 else "tree", v & 15)
        return out


DFT_MXU64 = DftMxuKernel("dft_mxu64", "nfl_dft_mxu64", 8, twiddle=False)
DFT_MXU64_TW = DftMxuKernel("dft_mxu64_twiddle", "nfl_dft_mxu64", 8,
                            twiddle=True)
DFT_MXU32 = DftMxuKernel("dft_mxu32", "nfl_dft_mxu32", 4, twiddle=None,
                         small_p_entry="nfl_dft_mxu32_small_p")
DFT_MXU64_PIPE = DftMxuKernel("dft_mxu64_pipe", "nfl_dft_mxu64_pipe", 8,
                              twiddle=None)
_NARROW, _U64 = ("u16", "u32"), ("u64",)
NTT_BUTTERFLY_FWD = ButterflyNttKernel("ntt_butterfly_fwd", False, _NARROW)
NTT_BUTTERFLY_INV = ButterflyNttKernel("ntt_butterfly_inv", True, _NARROW)
NTT_BUTTERFLY64_FWD = ButterflyNttKernel("ntt_butterfly64_fwd", False, _U64)
NTT_BUTTERFLY64_INV = ButterflyNttKernel("ntt_butterfly64_inv", True, _U64)
LWE_ENCRYPT = LweEncryptKernel("lwe_encrypt", _NARROW)
LWE_DECRYPT = LweDecryptKernel("lwe_decrypt", _NARROW)
LWE64_ENCRYPT = LweEncryptKernel("lwe64_encrypt", _U64)
LWE64_DECRYPT = LweDecryptKernel("lwe64_decrypt", _U64)
SALSA20 = Salsa20Kernel("salsa20")
SALSA20_UNIFORM = Salsa20SamplerKernel("salsa20_uniform", "uniform")
SALSA20_NON_UNIFORM = Salsa20SamplerKernel("salsa20_non_uniform",
                                           "non_uniform")
SALSA20_ZO = Salsa20SamplerKernel("salsa20_zo", "zo")
GAUSSIAN_FIXED = GaussianFixedKernel("gaussian_fixed")
GAUSSIAN_EXACT = GaussianExactKernel("gaussian_exact")
MODOPS_EXPR = ModopsExprKernel("modops_expr")
HWT_EXACT = HwtExactKernel("hwt_exact")
HWT_FIXED = HwtFixedKernel("hwt_fixed")
KERNELS = (DFT_MXU64, DFT_MXU64_TW, DFT_MXU32, DFT_MXU64_PIPE,
           NTT_BUTTERFLY_FWD, NTT_BUTTERFLY_INV, NTT_BUTTERFLY64_FWD,
           NTT_BUTTERFLY64_INV, LWE_ENCRYPT, LWE_DECRYPT, LWE64_ENCRYPT,
           LWE64_DECRYPT, SALSA20, SALSA20_UNIFORM, SALSA20_NON_UNIFORM,
           SALSA20_ZO, GAUSSIAN_FIXED, GAUSSIAN_EXACT, MODOPS_EXPR, HWT_EXACT,
           HWT_FIXED)
