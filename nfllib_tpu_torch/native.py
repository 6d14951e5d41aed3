"""ctypes loader for the port's native host runtime (csrc/nfl_native.cpp).

Port of nfllib_tpu/native.py: the C++ slot for the reference's native PRNG
layer (the qhasm Salsa20 assembly at lib/prng/*.s + fastrandombytes.cpp)
and the host loops that sit on it: the uniform sampler, CRT lifting and
the stream-exact Gaussian walk.  The port keeps its own copy of the
source and builds it at first use with $CXX (default g++) into
nfllib_tpu_torch/_build/libnfl_native_<hash>.so, keyed by the source and
the flags; a build goes to a per-process temporary name and is renamed
into place, so concurrent processes never load a half-written file.
NFL_NO_NATIVE (any non-empty value) turns the tier off; it is read once a
process, at the first get_lib().  Without a compiler everything falls back
to the numpy / Python tier, whose outputs are identical.

Residue arrays cross this boundary as the unsigned limb dtype (the JAX
package's layout, `Poly.numpy()`), never as the port's signed storage.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "csrc" / "nfl_native.cpp"
_BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
STATE_BYTES = 40          # 32-byte key || 64-bit little-endian nonce

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> pathlib.Path:
    """The library's path, keyed by the source and the flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libnfl_native_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> bool:
    cxx = os.environ.get("CXX", "g++")
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _declare(lib) -> None:
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    sigs = {
        "nfl_salsa20_stream": [vp, u64, ctypes.c_char_p, ctypes.c_char_p],
        "nfl_fastrandombytes": [vp, vp, u64],
        "nfl_uniform_u16": [vp, vp, vp, u64, u64, ctypes.c_uint16],
        "nfl_uniform_u32": [vp, vp, vp, u64, u64, ctypes.c_uint32],
        "nfl_uniform_u64": [vp, vp, vp, u64, u64, u64],
        "nfl_poly2mpz": [vp] * 5 + [u64] * 3 + [vp, vp],
        "nfl_mpz2poly": [vp, u64, u64, u64, vp, vp],
        "nfl_gaussian_noise": [vp, vp, u64, u64, u64, u64]
                              + [vp] * 10 + [u64, u64],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("NFL_NO_NATIVE"):
            return None
        path = _so_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _need_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native tier is not available "
                           "(NFL_NO_NATIVE set, or no C++ compiler)")
    return lib


def _check_state(state: np.ndarray) -> None:
    if (not isinstance(state, np.ndarray) or state.dtype != np.uint8
            or state.shape != (STATE_BYTES,)
            or not state.flags.c_contiguous):
        raise ValueError("state must be a contiguous uint8 array of 40 "
                         "bytes (native.make_state)")


def salsa20_stream(nbytes: int, nonce: bytes, key: bytes) -> bytes:
    """crypto_stream_salsa20: `nbytes` of keystream under (key, nonce)."""
    lib = _need_lib()
    if len(key) != 32 or len(nonce) != 8 or nbytes < 0:
        raise ValueError("Salsa20 needs a 32-byte key, an 8-byte nonce and "
                         "nbytes >= 0")
    out = ctypes.create_string_buffer(nbytes)
    lib.nfl_salsa20_stream(out, nbytes, nonce, key)
    return out.raw


def make_state(key: bytes, nonce: int) -> np.ndarray:
    """40-byte fastrandombytes state: key || little-endian nonce."""
    if len(key) != 32:
        raise ValueError("Salsa20 key must be 32 bytes")
    return np.frombuffer(
        key + int(nonce).to_bytes(8, "little"), dtype=np.uint8).copy()


def state_nonce(state: np.ndarray) -> int:
    return int.from_bytes(state[32:].tobytes(), "little")


def fastrandombytes(state: np.ndarray, nbytes: int) -> bytes:
    """`nbytes` of keystream at the state's nonce; bumps the nonce once."""
    lib = _need_lib()
    _check_state(state)
    out = np.empty(nbytes, dtype=np.uint8)
    lib.nfl_fastrandombytes(state.ctypes.data, out.ctypes.data, nbytes)
    return out.tobytes()


def uniform(state: np.ndarray, moduli: np.ndarray, degree: int,
            modulus_bits: int) -> np.ndarray:
    """Native uniform residue sampling (mask + one conditional subtract):
    [m, degree] in the moduli's unsigned limb dtype."""
    lib = _need_lib()
    _check_state(state)
    moduli = np.ascontiguousarray(moduli)
    dt = moduli.dtype
    if dt.kind != "u" or moduli.ndim != 1:
        raise ValueError(f"moduli must be a 1-d unsigned limb array, got "
                         f"{dt} {moduli.shape}")
    suffix = {2: "u16", 4: "u32", 8: "u64"}[dt.itemsize]
    m = len(moduli)
    data = np.empty((m, degree), dtype=dt)
    mask = (1 << modulus_bits) - 1
    getattr(lib, f"nfl_uniform_{suffix}")(
        state.ctypes.data, data.ctypes.data, moduli.ctypes.data, m, degree,
        mask)
    return data


# ---------------------------------------------------------------------------
# CRT lifting (gmp-free; see csrc nfl_poly2mpz / nfl_mpz2poly)
# ---------------------------------------------------------------------------

def _int_to_words(v: int, W: int) -> np.ndarray:
    return np.frombuffer(int(v).to_bytes(W * 8, "little"), dtype="<u8")


def poly2mpz_native(residues: np.ndarray, ctx) -> list:
    """residues [m, n] in the unsigned limb dtype -> list of python ints
    (canonical mod prod).  The port's signed storage must not come here:
    widening int32 to uint64 would sign-extend a residue >= 2^31."""
    lib = _need_lib()
    residues = np.asarray(residues)
    if residues.dtype.kind != "u" or residues.ndim != 2:
        raise ValueError(f"residues must be an unsigned [m, n] array "
                         f"(Poly.numpy()), got {residues.dtype} "
                         f"{residues.shape}")
    m, n = residues.shape
    prod = ctx.moduli_product
    W = (prod.bit_length() + 63) // 64
    qtab = np.empty((m, W), dtype=np.uint64)
    invtab = np.empty(m, dtype=np.uint64)
    for cm in range(m):
        p = int(ctx.ring.moduli[cm])
        q = prod // p
        qtab[cm] = _int_to_words(q, W)
        invtab[cm] = pow(q, -1, p)
    prodw = _int_to_words(prod, W).astype(np.uint64)
    mod = np.array([int(x) for x in ctx.ring.moduli], dtype=np.uint64)
    res64 = np.ascontiguousarray(residues.astype(np.uint64))
    out = np.zeros((n, W), dtype=np.uint64)
    scratch = np.zeros(W + 1, dtype=np.uint64)
    lib.nfl_poly2mpz(res64.ctypes.data, qtab.ctypes.data, invtab.ctypes.data,
                     prodw.ctypes.data, mod.ctypes.data, m, n, W,
                     out.ctypes.data, scratch.ctypes.data)
    return [int.from_bytes(out[i].tobytes(), "little") for i in range(n)]


def mpz2poly_native(values, ring) -> np.ndarray:
    """`degree` nonnegative python ints -> residues [m, n] in the unsigned
    limb dtype."""
    lib = _need_lib()
    n, m = ring.degree, ring.nmoduli
    values = [int(v) for v in values]
    if len(values) != n or any(v < 0 for v in values):
        raise ValueError(f"expected {n} nonnegative coefficients")
    maxbits = max((v.bit_length() for v in values), default=1)
    W = max(1, (maxbits + 63) // 64)
    coeffs = np.empty((n, W), dtype=np.uint64)
    for i, v in enumerate(values):
        coeffs[i] = _int_to_words(v, W)
    mod = np.array([int(x) for x in ring.moduli], dtype=np.uint64)
    out = np.zeros((m, n), dtype=np.uint64)
    lib.nfl_mpz2poly(coeffs.ctypes.data, m, n, W, mod.ctypes.data,
                     out.ctypes.data)
    return out.astype(ring.dtype)


# ---------------------------------------------------------------------------
# Discrete Gaussian walk (native tier of prng/gaussian.py)
# ---------------------------------------------------------------------------

def flatten_gaussian_tables(fg):
    """Flatten a FastGaussianNoise's lookup structures for the C walk."""
    size = fg._lu_size
    lu_val = np.ascontiguousarray(fg.lu_val.astype(np.int64))
    lu_flag = np.ascontiguousarray(fg.lu_flag.astype(np.uint8))
    lu1_map = np.full(size, -1, dtype=np.int32)
    bars1_first = np.zeros(size, dtype=np.int32)
    bars1_count = np.zeros(size, dtype=np.int32)
    if fg.lu_depth == 1:
        for w0, lst in enumerate(fg.lu_barriers):
            if lst:
                bars1_first[w0] = lst[0]
                bars1_count[w0] = len(lst)
        val2 = np.zeros((1, size), dtype=np.int64)
        flag2 = np.zeros((1, size), dtype=np.uint8)
        bars2_first = np.zeros((1, size), dtype=np.int32)
        bars2_count = np.zeros((1, size), dtype=np.int32)
    else:
        keys = sorted(fg.lu2.keys())
        nf = max(1, len(keys))
        val2 = np.zeros((nf, size), dtype=np.int64)
        flag2 = np.zeros((nf, size), dtype=np.uint8)
        bars2_first = np.zeros((nf, size), dtype=np.int32)
        bars2_count = np.zeros((nf, size), dtype=np.int32)
        for f, w0 in enumerate(keys):
            lu1_map[w0] = f
            v2, fl2, b2 = fg.lu2[w0]
            val2[f] = v2.astype(np.int64)
            flag2[f] = fl2.astype(np.uint8)
            for w1, lst in b2.items():
                bars2_first[f, w1] = lst[0]
                bars2_count[f, w1] = len(lst)
    bw = np.ascontiguousarray(fg.barrier_words.astype(np.uint16))
    return dict(lu_val=lu_val, lu_flag=lu_flag, lu1_map=lu1_map,
                bars1_first=bars1_first, bars1_count=bars1_count,
                val2=val2, flag2=flag2, bars2_first=bars2_first,
                bars2_count=bars2_count, barrier_words=bw)


def gaussian_noise(fg, tables: dict, state: np.ndarray,
                   rlen: int) -> np.ndarray:
    """Run the native walk; mutates `state` exactly like the python walk."""
    lib = _need_lib()
    _check_state(state)
    innoise_words = int(np.float32(rlen) * np.float32(fg.innoise_multiplier))
    out = np.empty(rlen, dtype=np.int64)
    t = tables
    lib.nfl_gaussian_noise(
        state.ctypes.data, out.ctypes.data, rlen,
        fg.word_precision, fg.in_bits // 8, innoise_words,
        t["lu_val"].ctypes.data, t["lu_flag"].ctypes.data,
        t["lu1_map"].ctypes.data, t["bars1_first"].ctypes.data,
        t["bars1_count"].ctypes.data,
        t["val2"].ctypes.data, t["flag2"].ctypes.data,
        t["bars2_first"].ctypes.data, t["bars2_count"].ctypes.data,
        t["barrier_words"].ctypes.data, fg.lu_depth, fg._lu_size)
    return out
