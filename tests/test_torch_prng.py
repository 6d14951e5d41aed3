"""The port's Salsa20 stream and uniform sampler: byte-exact against the
reference's keystream dump and the JAX package's host sampler."""
import os

import numpy as np
import pytest

import nfllib_tpu as nfl
from nfllib_tpu.prng import Salsa20Stream as JStream
from nfllib_tpu.prng.sampling import sample_uniform as jsample_uniform
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import Salsa20Stream, crypto_stream
from nfllib_tpu_torch.prng.sampling import sample, sample_uniform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_keystream_equals_golden_dump():
    """The four records of tools/golden/salsa20_dump.c, written by the
    reference's qhasm assembly."""
    with open(os.path.join(ROOT, "tools", "golden", "salsa20_golden.bin"),
              "rb") as f:
        golden = f.read()
    key = bytes(range(32))
    stream = Salsa20Stream(key)
    assert stream.randombytes(1024) == golden[:1024]         # nonce 0
    assert stream.randombytes(1024) == golden[1024:2048]     # nonce 1
    nonce = (0x0123456789ABCDEF).to_bytes(8, "little")
    assert crypto_stream(777, nonce, bytes([0xAA] * 32)) == golden[2048:2825]
    assert crypto_stream(64, bytes(8), bytes(32)) == golden[2825:2889]
    assert len(golden) == 2889


def test_stream_state_follows_reference():
    """Each call restarts at block 0 under the current nonce, then bumps
    the nonce, as the JAX package's stream does."""
    key = bytes(range(7, 39))
    t, j = Salsa20Stream(key, nonce=5), JStream(key, nonce=5)
    for nbytes in (1, 63, 64, 65, 1000):
        assert t.randombytes(nbytes) == j.randombytes(nbytes)
    assert t.nonce == j.nonce == 10
    wrapped = Salsa20Stream(key, nonce=(1 << 64) - 1)
    wrapped.randombytes(4)
    assert wrapped.nonce == 0
    with pytest.raises(ValueError):
        Salsa20Stream(b"short")
    assert len(Salsa20Stream.from_system_entropy().randombytes(16)) == 16


@pytest.mark.parametrize("degree,agg,limb", [(8, 60, "u32"), (128, 14, "u16"),
                                             (1024, 510, "u32"),
                                             (512, 28, "u16"),
                                             (512, 124, "u64"),
                                             (16384, 496, "u64")])
def test_sample_uniform_equals_jax_host_sampler(degree, agg, limb):
    key = bytes(range(32, 64))
    jr = nfl.ring_from_modulus(limb, degree, agg)
    tr = tnfl.ring_from_modulus(limb, degree, agg)
    js, ts = JStream(key), Salsa20Stream(key)
    for _ in range(2):
        want = jsample_uniform(jr, js)
        got = sample_uniform(tr, ts)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert (got < np.asarray(tr.moduli, dtype=got.dtype)[:, None]).all()
    assert ts.nonce == js.nonce
    with pytest.raises(TypeError):
        sample(tr, object(), ts)
