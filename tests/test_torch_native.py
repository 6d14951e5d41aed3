"""The port's native host runtime (nfllib_tpu_torch/native.py over its own
csrc/nfl_native.cpp) against the golden keystream of the reference's
x86-64 assembly, the port's numpy / Python tier and the JAX package's
native tier: keystream bytes, stream state, uniform residues, CRT lifting
both ways and the stream-exact Gaussian walk, all exact; a host LWE
encryption equal to the JAX package's; NFL_NO_NATIVE and the build's
location checked in subprocesses (the loader reads the variable once a
process)."""
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu import crt as jcrt
from nfllib_tpu import native as jnative
from nfllib_tpu.apps import lwe as jlwe
from nfllib_tpu.prng import Salsa20Stream as JStream
from nfllib_tpu.prng.gaussian import FastGaussianNoise as JGaussian
from nfllib_tpu.prng.sampling import sample_uniform as jsample_uniform
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import crt, native
from nfllib_tpu_torch.apps import lwe as tlwe
from nfllib_tpu_torch.prng import Salsa20Stream, crypto_stream
from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
from nfllib_tpu_torch.prng.sampling import sample_uniform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tools", "golden", "salsa20_golden.bin")
DEV = "cpu"
M64 = (1 << 64) - 1


def _python_stream(key, nonce=0):
    """A stream on the numpy tier whatever the process's native tier."""
    s = Salsa20Stream(key, nonce)
    s._native = None
    return s


@pytest.fixture(scope="module", autouse=True)
def _native_tier():
    """g++ is part of the test environment: the native tier must build."""
    assert native.available(), "the port's native tier did not build"


@functools.lru_cache(maxsize=None)
def _gaussian(in_bits, lu_depth):
    return FastGaussianNoise(3.2, 100, 1 << 8, in_bits=in_bits,
                             lu_depth=lu_depth)


def test_stream_matches_reference_golden():
    """Four segments dumped from the reference's qhasm assembly
    (tools/golden/salsa20_dump.c)."""
    gold = open(GOLDEN, "rb").read()
    cases = [(bytes(range(32)), 0, 1024), (bytes(range(32)), 1, 1024),
             (b"\xAA" * 32, 0x0123456789ABCDEF, 777), (b"\x00" * 32, 0, 64)]
    off = 0
    for key, nonce, length in cases:
        got = native.salsa20_stream(length, nonce.to_bytes(8, "little"), key)
        assert got == gold[off:off + length], (nonce, length)
        off += length
    assert off == len(gold)
    stream = Salsa20Stream(bytes(range(32)))
    assert stream._native is native
    assert stream.randombytes(1024) + stream.randombytes(1024) == gold[:2048]


@pytest.mark.parametrize("nonce", [0, 1, 1 << 40, M64])
def test_stream_matches_numpy_tier(nonce):
    key = b"\xAB" * 32
    n8 = nonce.to_bytes(8, "little")
    for nbytes in (0, 1, 63, 64, 65, 1000):
        assert (native.salsa20_stream(nbytes, n8, key)
                == crypto_stream(nbytes, n8, key))
    a, b = Salsa20Stream(key, nonce), _python_stream(key, nonce)
    for nbytes in (5, 64, 300):
        assert a.randombytes(nbytes) == b.randombytes(nbytes)
    assert a.nonce == b.nonce == (nonce + 3) & M64


@pytest.mark.parametrize("offset", [0, 5, 64, 100, 4096 + 17])
def test_stream_at_an_offset(offset):
    """Bytes offset .. offset + nbytes - 1 of a call's stream, in both
    tiers, are those of the call from byte 0, and the nonce moves once
    (a channel block's uniform draw reads from first * n limbs on)."""
    key, nonce = b"\x5C" * 32, (1 << 40) + 3
    n8 = nonce.to_bytes(8, "little")
    for nbytes in (0, 1, 59, 64, 65, 1000):
        want = crypto_stream(offset + nbytes, n8, key)[offset:]
        assert native.salsa20_stream(nbytes, n8, key, offset) == want
        assert crypto_stream(nbytes, n8, key, offset) == want
    a, b = Salsa20Stream(key, nonce), _python_stream(key, nonce)
    assert a.randombytes(300, offset) == b.randombytes(300, offset) \
        == crypto_stream(offset + 300, n8, key)[offset:]
    assert a.nonce == b.nonce == nonce + 1


def test_fastrandombytes_state_progression():
    key = b"\x11" * 32
    state = native.make_state(key, 0)
    a = native.fastrandombytes(state, 100)
    b = native.fastrandombytes(state, 100)
    assert native.state_nonce(state) == 2
    s = _python_stream(key)
    assert s.randombytes(100) == a and s.randombytes(100) == b
    # the 64-bit nonce wraps, in the state and in the stream
    state = native.make_state(key, M64)
    assert native.fastrandombytes(state, 8) == crypto_stream(
        8, M64.to_bytes(8, "little"), key)
    assert native.state_nonce(state) == 0
    with pytest.raises(ValueError):
        native.fastrandombytes(np.zeros(39, dtype=np.uint8), 8)


@pytest.mark.parametrize("limb,n,agg", [("u16", 128, 14), ("u32", 256, 60),
                                        ("u64", 64, 124)])
def test_native_uniform_matches_python_sampler(limb, n, agg):
    key = b"\x42" * 32
    ring = tnfl.ring_from_modulus(limb, n, agg)
    state = native.make_state(key, 7)
    got = native.uniform(state, np.array(ring.moduli, dtype=ring.dtype),
                         ring.degree, ring.modulus_bits)
    assert native.state_nonce(state) == 8
    py = _python_stream(key, 7)
    want = sample_uniform(ring, py)
    assert got.dtype == want.dtype == ring.dtype
    np.testing.assert_array_equal(got, want)
    assert py.nonce == 8
    # the sampler's native branch bumps the nonce exactly once
    ts = Salsa20Stream(key, 7)
    np.testing.assert_array_equal(sample_uniform(ring, ts), want)
    assert ts.nonce == 8
    js = JStream(key, 7)
    np.testing.assert_array_equal(
        jsample_uniform(nfl.ring_from_modulus(limb, n, agg), js), want)


CRT_RINGS = [("u16", 64, 14), ("u32", 128, 90), ("u32", 1024, 60),
             ("u64", 32, 124), ("u64", 64, 496)]


@pytest.mark.parametrize("limb,n,agg", CRT_RINGS)
def test_native_crt_matches_python(limb, n, agg):
    """poly2mpz / mpz2poly on the native tier against the Python tier and
    the JAX package, with whole channels at p - 1 and at 0: the residues
    reach the library unsigned (a signed array is refused)."""
    ring = tnfl.ring_from_modulus(limb, n, agg)
    ctx = ring.context()
    arr = tnfl.Poly.sample(ring, tnfl.uniform(), Salsa20Stream(b"\x21" * 32),
                           DEV).numpy().copy()
    p = np.array(ring.moduli, dtype=ring.dtype)
    arr[0] = p[0] - 1
    arr[-1, : n // 2] = 0
    arr[:, -1] = p - 1
    poly = tnfl.Poly.from_numpy(ring, arr, DEV)
    got = crt.poly2mpz(poly)
    assert got == native.poly2mpz_native(arr, ctx)
    assert got == crt._poly2mpz_py(arr, ctx)
    jring = nfl.ring_from_modulus(limb, n, agg)
    assert got == jcrt.poly2mpz(nfl.Poly(arr, jring))
    assert got[-1] == ctx.moduli_product - 1
    back = crt.mpz2poly(ring, got, DEV)
    assert back.device == torch.device(DEV)
    np.testing.assert_array_equal(back.numpy(), arr)
    np.testing.assert_array_equal(native.mpz2poly_native(got, ring), arr)
    # negative and oversized values take the Python tier (floor semantics)
    vals = [-v for v in got[:-1]] + [got[-1] + 5 * ctx.moduli_product]
    np.testing.assert_array_equal(
        crt.mpz2poly(ring, vals, DEV).numpy(),
        np.asarray(jcrt.mpz2poly(jring, vals).data))
    with pytest.raises(ValueError):
        native.poly2mpz_native(arr.view(ring.limb_params.signed_dtype), ctx)


@pytest.mark.parametrize("in_bits", [8, 16])
@pytest.mark.parametrize("lu_depth", [1, 2])
def test_native_gaussian_walk_matches_python(in_bits, lu_depth):
    """The C walk replicates the Python walk: the same values and the same
    stream consumption (nonce advance), across refills: a 50-sample
    walk's buffer runs out before its last samples on some keys."""
    fg = _gaussian(in_bits, lu_depth)
    tables = native.flatten_gaussian_tables(fg)
    nf = max(1, len(fg.lu2)) if lu_depth == 2 else 1
    assert tables["val2"].shape == (nf, 1 << in_bits)
    refills = 0
    for key, rlen in [(b"\x11" * 32, 3000)] + [(bytes([k]) * 32, 50)
                                               for k in range(8)]:
        s1, s2 = Salsa20Stream(key, 3), Salsa20Stream(key, 3)
        a = fg.get_noise(s1, rlen)                  # native walk
        b = fg._get_noise_py(s2, rlen)              # Python walk
        np.testing.assert_array_equal(a, b)
        assert s1.nonce == s2.nonce >= 4
        refills += s1.nonce - 4
    assert refills > 0
    assert fg._native_tables["val2"].shape == tables["val2"].shape


def test_native_outputs_match_jax_native():
    """The port's library and the JAX package's on the same keys: stream,
    uniform, CRT lift and the Gaussian walk."""
    assert jnative.available()
    key, n8 = bytes(range(100, 132)), (123456789).to_bytes(8, "little")
    assert native.salsa20_stream(999, n8, key) == jnative.salsa20_stream(
        999, n8, key)
    ring = tnfl.ring_from_modulus("u64", 64, 124)
    ts, js = native.make_state(key, 9), jnative.make_state(key, 9)
    mod = np.array(ring.moduli, dtype=ring.dtype)
    u = native.uniform(ts, mod, ring.degree, ring.modulus_bits)
    np.testing.assert_array_equal(
        u, jnative.uniform(js, mod, ring.degree, ring.modulus_bits))
    assert native.state_nonce(ts) == jnative.state_nonce(js) == 10
    jring = nfl.ring_from_modulus("u64", 64, 124)
    assert native.poly2mpz_native(u, ring.context()) == \
        jnative.poly2mpz_native(u, jring.context())
    fg, jfg = FastGaussianNoise(4.0, 128, 1 << 10), JGaussian(4.0, 128,
                                                              1 << 10)
    a = native.gaussian_noise(fg, native.flatten_gaussian_tables(fg), ts,
                              5000)
    b = jnative.gaussian_noise(jfg, jnative.flatten_gaussian_tables(jfg), js,
                               5000)
    np.testing.assert_array_equal(a, b)
    assert native.state_nonce(ts) == jnative.state_nonce(js)


def test_host_encrypt_equals_jax():
    """keygen and one host encrypt of the port (native stream, uniform and
    walk) equal the JAX package's at the same key and nonce."""
    key = b"\x05" * 32
    ring = tnfl.ring_from_modulus("u32", 1024, 60)
    jring = nfl.ring_from_modulus("u32", 1024, 60)
    ts, js = Salsa20Stream(key), JStream(key)
    g, jg = tlwe.make_gaussian_prng(), jlwe.make_gaussian_prng()
    keys, jkeys = tlwe.keygen(ring, ts, g, DEV), jlwe.keygen(jring, js, jg)
    for name in ("s", "sprime", "pka", "pkb"):
        np.testing.assert_array_equal(getattr(keys, name).numpy(),
                                      np.asarray(getattr(jkeys, name).data))
    ra, rb = tlwe.encrypt(keys, ring, ts, g)
    ja, jb = jlwe.encrypt(jkeys, jring, js, jg)
    np.testing.assert_array_equal(ra.numpy(), np.asarray(ja.data))
    np.testing.assert_array_equal(rb.numpy(), np.asarray(jb.data))
    assert ts.nonce == js.nonce
    assert not tlwe.decrypt(keys, ring, ra, rb).any()


def _run(code, **env):
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, **env}, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


def test_no_native_env_honoured():
    """NFL_NO_NATIVE=1: no library, every sampler on the Python tier, the
    same bytes and residues as the native tier."""
    code = (
        "import hashlib, sys\n"
        "import nfllib_tpu_torch as t\n"
        "from nfllib_tpu_torch import native\n"
        "from nfllib_tpu_torch.apps import lwe\n"
        "from nfllib_tpu_torch.prng import Salsa20Stream\n"
        "s = Salsa20Stream(bytes(range(32)))\n"
        "r = t.ring_from_modulus('u32', 256, 60)\n"
        "g = lwe.make_gaussian_prng()\n"
        "h = hashlib.sha256(s.randombytes(100))\n"
        "h.update(t.Poly.sample(r, t.uniform(), s, 'cpu').numpy()"
        ".tobytes())\n"
        "h.update(t.Poly.sample(r, t.gaussian(g), s, 'cpu').numpy()"
        ".tobytes())\n"
        "print(native.available(), s._native is None, s.nonce, "
        "h.hexdigest())\n")
    off = _run(code, NFL_NO_NATIVE="1").split()
    on = _run(code).split()
    assert off[:2] == ["False", "True"] and on[:2] == ["True", "False"]
    assert off[2:] == on[2:]


def test_build_lands_in_the_ports_build_dir(tmp_path):
    """A fresh build compiles the port's own source into the build
    directory it is given and loads it from there; the JAX package's
    csrc/ and its library are neither built nor loaded."""
    code = (
        "import pathlib, subprocess, sys\n"
        "from nfllib_tpu_torch import native\n"
        f"native._BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "calls = []\n"
        "run = subprocess.run\n"
        "def spy(cmd, **kw):\n"
        "    calls.append(cmd)\n"
        "    return run(cmd, **kw)\n"
        "subprocess.run = spy\n"
        "assert native.available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "so = native._so_path()\n"
        "assert len(calls) == 1 and calls[0][-1] == str(native._SRC), calls\n"
        "assert so.parent == native._BUILD_DIR and str(so) in maps\n"
        "assert 'csrc/libnfl_native.so' not in maps\n"
        "assert not any(m.startswith('jax') or m.split('.')[0] == "
        "'nfllib_tpu' for m in sys.modules)\n"
        "print(native._SRC, so.name)\n")
    src, name = _run(code).split()
    assert src == os.path.realpath(
        os.path.join(ROOT, "nfllib_tpu_torch", "csrc", "nfl_native.cpp"))
    assert [p.name for p in tmp_path.iterdir()] == [name]
    assert native._so_path().parent == \
        native._HERE / "_build"
    assert native._so_path().parent.parent.name == "nfllib_tpu_torch"
