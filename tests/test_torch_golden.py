"""The port against the golden vectors that the compiled C++ NFLlib wrote
(tools/golden/nfl_golden_*.bin.xz, key bytes(range(32))), byte for byte.

The replay follows tests/test_golden_interop.py: the same key, the same
record order, the same shared Salsa20 stream.  It covers the records that
need only what the port has: moduli, the uniform samples, the modular ops,
NTT / INTT and both serializers.  The records from `non_uniform_4` on draw
from the shared stream with samplers the port does not have yet
(non_uniform, ZO, hwt, gaussian, and the LWE transcript built on them);
they are skipped by name and belong to the sampler slice.
`serialize_manual` and `cereal_binary` depend only on c = a + b, so they
are still checked."""
import lzma
import pathlib
import struct

import numpy as np
import pytest

import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import Salsa20Stream

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "tools" / "golden"
KEY = bytes(range(32))

CONFIGS = [
    ("8_60_u32", "u32", 8, 60),
    ("128_14_u16", "u16", 128, 14),
    ("1024_60_u32", "u32", 1024, 60),
    ("4096_60_u32", "u32", 4096, 60),
    ("8192_124_u64", "u64", 8192, 124),
    ("32768_124_u64", "u64", 32768, 124),
    ("16384_496_u64", "u64", 16384, 496),
]

# records that need the samplers of a later slice
SAMPLER_RECORDS = ("non_uniform_4", "non_uniform_10_amp2", "zo_7f",
                   "gaussian_s20", "gaussian_s20_amp2", "lwe_s",
                   "lwe_sprime", "lwe_pka", "lwe_pkb", "lwe_resa",
                   "lwe_resb", "lwe_dec_raw", "lwe_dec_bits")


def load_golden(cfg):
    raw = lzma.open(GOLDEN_DIR / f"nfl_golden_{cfg}.bin.xz").read()
    records = []
    off = 0
    while off < len(raw):
        (nl,) = struct.unpack_from("<I", raw, off)
        off += 4
        name = raw[off:off + nl].decode()
        off += nl
        (dl,) = struct.unpack_from("<Q", raw, off)
        off += 8
        records.append((name, raw[off:off + dl]))
        off += dl
    return records


def assert_poly(rec_bytes, p, name, cfg):
    got = tnfl.serialize_poly(p.poly() if isinstance(p, tnfl.Expr) else p)
    assert got == rec_bytes, (
        f"{cfg}/{name}: {np.frombuffer(got, p.ring.dtype)[:4]} != "
        f"{np.frombuffer(rec_bytes, p.ring.dtype)[:4]} ...")


@pytest.mark.parametrize("cfg,limb,degree,modbits", CONFIGS)
def test_golden_replay(cfg, limb, degree, modbits):
    ring = tnfl.ring_from_modulus(limb, degree, modbits)
    stream = Salsa20Stream(KEY)
    env = {}
    checked, skipped = [], []
    for name, data in load_golden(cfg):
        if name in SAMPLER_RECORDS or name.startswith("hwt_"):
            skipped.append(name)
            continue
        checked.append(name)
        if name == "moduli":
            assert data == np.array(ring.moduli, dtype="<u8").tobytes()
        elif name in ("uniform_a", "uniform_b"):
            p = tnfl.Poly.sample(ring, tnfl.uniform(), stream)
            env[name[-1]] = p
            assert_poly(data, p, name, cfg)
        elif name == "add":
            env["c"] = (env["a"] + env["b"]).poly()
            assert_poly(data, env["c"], name, cfg)
        elif name == "sub":
            assert_poly(data, env["a"] - env["b"], name, cfg)
        elif name == "mul":
            assert_poly(data, env["a"].mulmod(env["b"]), name, cfg)
        elif name == "shoup_prec":
            env["prec"] = env["b"].compute_shoup()
            assert_poly(data, env["prec"], name, cfg)
        elif name == "mulmod_shoup":
            assert_poly(data, tnfl.shoup(env["a"] * env["b"], env["prec"]),
                        name, cfg)
        elif name == "fma":
            assert_poly(data, env["a"] * env["b"] + env["c"], name, cfg)
        elif name == "fma_shoup":
            # the reference expression c + shoup(a*b, prec) evaluates
            # addmod(c, mulmod_shoup(...)), both canonical
            assert_poly(data, env["c"] + tnfl.shoup(env["a"] * env["b"],
                                                    env["prec"]), name, cfg)
        elif name == "ntt":
            env["antt"] = env["a"].ntt_pow_phi()
            assert_poly(data, env["antt"], name, cfg)
        elif name == "intt":
            back = env["antt"].invntt_pow_invphi()
            assert_poly(data, back, name, cfg)
            assert back == env["a"]
        elif name == "intt_of_b":
            assert_poly(data, env["b"].invntt_pow_invphi(), name, cfg)
        elif name in ("serialize_manual", "cereal_binary"):
            # cereal's binary archive of the raw C array == the manual bytes
            assert env["c"].serialize_manually() == data
            back = tnfl.deserialize_poly(ring, data)
            assert back == env["c"]
        else:
            raise AssertionError(f"unknown golden record {name!r}")
    assert {"uniform_a", "ntt", "intt", "serialize_manual",
            "cereal_binary"} <= set(checked)
    assert skipped[0] == "non_uniform_4"
