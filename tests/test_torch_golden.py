"""The port against the golden vectors that the compiled C++ NFLlib wrote
(tools/golden/nfl_golden_*.bin.xz, key bytes(range(32))), byte for byte.

The replay follows tests/test_golden_interop.py: the same key, the same
record order, the same shared Salsa20 stream.  It covers every record:
moduli, the uniform samples, the modular ops, NTT / INTT, the non_uniform,
ZO, hwt and gaussian samplers, the LWE transcript (keys, one encryption of
zero, the raw decryption and its bits) and both serializers.  Nothing is
skipped.  The replay itself is nfllib_tpu_torch/golden.py; the tensors
live on the CPU (DEV)."""
import pathlib

import numpy as np
import pytest

import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import golden

GOLDEN_DIR = pathlib.Path(__file__).resolve().parent.parent / "tools" / "golden"

CONFIGS = [
    ("8_60_u32", "u32", 8, 60),
    ("128_14_u16", "u16", 128, 14),
    ("1024_60_u32", "u32", 1024, 60),
    ("4096_60_u32", "u32", 4096, 60),
    ("8192_124_u64", "u64", 8192, 124),
    ("32768_124_u64", "u64", 32768, 124),
    ("16384_496_u64", "u64", 16384, 496),
]

DEV = "cpu"


@pytest.mark.parametrize("cfg,limb,degree,modbits", CONFIGS)
def test_golden_replay(cfg, limb, degree, modbits):
    ring = tnfl.ring_from_modulus(limb, degree, modbits)
    records = golden.load_golden(GOLDEN_DIR / f"nfl_golden_{cfg}.bin.xz")
    checked = {}
    for name, got, want in golden.replay(ring, records, DEV):
        assert got == want, (
            f"{cfg}/{name}: {np.frombuffer(got, ring.dtype)[:4]} != "
            f"{np.frombuffer(want, ring.dtype)[:4]} ...")
        checked[name] = want
    # the INTT of the NTT of a is a; the serialized bytes deserialize to c
    assert checked["intt"] == checked["uniform_a"]
    for name in ("serialize_manual", "cereal_binary"):
        back = tnfl.deserialize_poly(ring, checked[name], device=DEV)
        assert tnfl.serialize_poly(back) == checked["add"]
    assert {"uniform_a", "ntt", "intt", "non_uniform_4", "zo_7f",
            "gaussian_s20", "lwe_s", "lwe_resa", "lwe_dec_bits",
            "serialize_manual", "cereal_binary"} <= set(checked)
    assert any(name.startswith("hwt_") for name in checked)
