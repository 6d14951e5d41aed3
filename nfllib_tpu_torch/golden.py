"""Replay of the golden vectors that the compiled C++ NFLlib wrote.

The dumps (tools/golden/nfl_golden_<degree>_<bits>_<limb>.bin.xz, written
with the key bytes(range(32))) are a stream of records, each a u32 name
length, the name, a u64 data length and the data.  `replay` recomputes
every record through the port, in the dumps' order and on one shared
Salsa20 stream: moduli, the uniform samples, the modular ops, NTT / INTT,
the non_uniform, ZO, hwt and gaussian samplers, the LWE transcript (keygen
step by step, one encryption of zero, the raw decryption and its bits) and
both serializers.  Callers compare the bytes.
"""
from __future__ import annotations

import lzma
import struct

import numpy as np

from .apps import lwe
from .poly import (Expr, Poly, ZO_dist, gaussian, hwt_dist, non_uniform,
                   shoup, uniform)
from .prng.gaussian import FastGaussianNoise
from .prng.salsa20 import Salsa20Stream
from .serialize import serialize_poly

KEY = bytes(range(32))


def load_golden(path):
    """[(name, data bytes)] of one .bin.xz dump, in order."""
    raw = lzma.open(path).read()
    off, records = 0, []
    while off < len(raw):
        (nl,) = struct.unpack_from("<I", raw, off)
        name = raw[off + 4:off + 4 + nl].decode()
        (dl,) = struct.unpack_from("<Q", raw, off + 4 + nl)
        off += 12 + nl
        records.append((name, raw[off:off + dl]))
        off += dl
    return records


def replay(ring, records, device):
    """Yield (name, got, want) for every record: `got` is the port's bytes
    for it on `device`, `want` the dump's.  Raises on a record name it does
    not know."""
    stream = Salsa20Stream(KEY)
    env = {}

    def sample(mode):
        return Poly.sample(ring, mode, stream, device)

    def ser(p):
        return serialize_poly(p.poly() if isinstance(p, Expr) else p)

    for name, want in records:
        if name == "moduli":
            got = np.array(ring.moduli, dtype="<u8").tobytes()
        elif name in ("uniform_a", "uniform_b"):
            env[name[-1]] = sample(uniform())
            got = ser(env[name[-1]])
        elif name == "add":
            env["c"] = (env["a"] + env["b"]).poly()
            got = ser(env["c"])
        elif name == "sub":
            got = ser(env["a"] - env["b"])
        elif name == "mul":
            got = ser(env["a"].mulmod(env["b"]))
        elif name == "shoup_prec":
            env["prec"] = env["b"].compute_shoup()
            got = ser(env["prec"])
        elif name == "mulmod_shoup":
            got = ser(shoup(env["a"] * env["b"], env["prec"]))
        elif name == "fma":
            got = ser(env["a"] * env["b"] + env["c"])
        elif name == "fma_shoup":
            # the reference expression c + shoup(a*b, prec) evaluates
            # addmod(c, mulmod_shoup(...)), both canonical
            got = ser(env["c"] + shoup(env["a"] * env["b"], env["prec"]))
        elif name == "ntt":
            env["antt"] = env["a"].ntt_pow_phi()
            got = ser(env["antt"])
        elif name == "intt":
            got = ser(env["antt"].invntt_pow_invphi())
        elif name == "intt_of_b":
            got = ser(env["b"].invntt_pow_invphi())
        elif name == "non_uniform_4":
            got = ser(sample(non_uniform(4)))
        elif name == "non_uniform_10_amp2":
            got = ser(sample(non_uniform(10, 2)))
        elif name == "zo_7f":
            got = ser(sample(ZO_dist(0x7F)))
        elif name.startswith("hwt_"):
            got = ser(sample(hwt_dist(int(name.split("_")[1]))))
        elif name == "gaussian_s20":
            env["fgn20"] = FastGaussianNoise(20, 128, 1 << 14)
            got = ser(sample(gaussian(env["fgn20"])))
        elif name == "gaussian_s20_amp2":
            got = ser(sample(gaussian(env["fgn20"], 2)))
        elif name == "lwe_s":
            # keygen as apps/lwe.py runs it, record by record
            env["fgn"] = lwe.make_gaussian_prng()
            env["s"] = sample(gaussian(env["fgn"])).ntt_pow_phi()
            got = ser(env["s"])
        elif name == "lwe_sprime":
            env["sprime"] = env["s"].compute_shoup()
            got = ser(env["sprime"])
        elif name == "lwe_pka":
            env["pka"] = sample(uniform())
            got = ser(env["pka"])
        elif name == "lwe_pkb":
            pkb = sample(gaussian(env["fgn"], 2)).ntt_pow_phi()
            env["keys"] = lwe.LweKeys(env["s"], env["sprime"], env["pka"], (
                pkb + shoup(env["pka"] * env["s"], env["sprime"])).poly())
            got = ser(env["keys"].pkb)
        elif name == "lwe_resa":
            # the app's encrypt draws u, e1, e2 from the stream as the
            # reference does, and its graph computes u*pka + e1, u*pkb + e2
            env["ct"] = lwe.encrypt(env["keys"], ring, stream, env["fgn"])
            got = ser(env["ct"][0])
        elif name == "lwe_resb":
            got = ser(env["ct"][1])
        elif name == "lwe_dec_raw":
            resa, resb = env["ct"]
            got = ser((resb - resa * env["s"]).invntt_pow_invphi())
        elif name == "lwe_dec_bits":
            bits = lwe.decrypt(env["keys"], ring, *env["ct"])
            got = bits.cpu().numpy().view(ring.dtype).astype(
                np.dtype(ring.dtype).newbyteorder("<")).tobytes()
        elif name in ("serialize_manual", "cereal_binary"):
            # cereal's binary archive of the raw C array == the manual bytes
            got = env["c"].serialize_manually()
        else:
            raise AssertionError(f"unknown golden record {name!r}")
        yield name, got, want
