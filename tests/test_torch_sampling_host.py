"""The keystream kernel's CUDA source (nfllib_tpu_torch/csrc/salsa20.cu, S1,
with salsa20_block.cuh) compiled with g++ for the host against
tests/cuda_host_mock.h, and its C entry point held to the plain twin
(prng/salsa20.py:keystream), exact, on the CPU.  The Gaussian's kernels
S3 and S4 have theirs in test_torch_gaussian_kernels.py.

The mock runs each block's threads as std::threads with a barrier, so S1's
staging through shared memory and its nonce arithmetic (device base, host
addend, offsets, the wrap at 2^64) run as written; that nvcc accepts it
and its speed stay with chip_smoke.py.  Without g++ the tests skip.
"""
import ctypes

import numpy as np
import pytest
import torch

import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import device_sampling as tdev
from nfllib_tpu_torch.prng import salsa20 as tsal
from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
from nfllib_tpu_torch.prng.sampling import gaussian

import cuda_host_build

P, I32, I64, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_ulonglong)
KEY = bytes(range(100, 132))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = cuda_host_build.build(tmp_path_factory.mktemp("sampling_host"),
                                ("salsa20_block.cuh", "salsa20.cu"),
                                ("salsa20.cu",))
    lib.nfl_salsa20.argtypes = [P, P, U64, P, I32, I64, P, P]
    return lib


def _p(t):
    return P(None if t is None else t.data_ptr())


def _s1(lib, key, nonce_t, nonce_add, offsets, fills, nblocks):
    words = (ctypes.c_uint32 * 8)(*np.frombuffer(key, dtype="<u4"))
    out = torch.empty((fills, nblocks * 16), dtype=torch.int32)
    lib.mock_launches()
    assert lib.nfl_salsa20(words, _p(nonce_t), nonce_add, _p(offsets), fills,
                           nblocks, _p(out), None) == 0
    assert lib.mock_launches() == 1
    return out


@pytest.mark.parametrize("nonce,fills,nblocks", [
    (0, 1, 1), (3, 1, 300), (7, 17, 20), ((1 << 64) - 2, 4, 3),
    ((1 << 63) - 1, 2, 257)])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_s1_matches_twin_and_host_stream(lib, nonce, fills, nblocks,
                                         as_tensor):
    """F streams at nonce, nonce + 1, ... (wrapping at 2^64), the nonce on
    the host or as a device word plus a host addend, against the twin and
    the numpy stream; a partly filled last block of 256 threads too."""
    if as_tensor:
        base = torch.tensor(tsal._signed64(nonce - 5), dtype=torch.int64)
        got = _s1(lib, KEY, base, 5, None, fills, nblocks)
        want = tsal.keystream(KEY, base + 5, nblocks, fills, "cpu")
    else:
        got = _s1(lib, KEY, None, nonce, None, fills, nblocks)
        want = tsal.keystream(KEY, nonce, nblocks, fills, "cpu")
    assert torch.equal(got, want)
    for f in range(fills):
        host = tsal.Salsa20Stream(KEY, (nonce + f) % (1 << 64))
        assert got[f].numpy().tobytes() == host.randombytes(64 * nblocks)


def test_s1_offsets_vector(lib):
    offsets = torch.tensor([9, 0, -1, 2], dtype=torch.int64)
    got = _s1(lib, KEY, None, 1, offsets, 4, 2)
    for f, off in enumerate((9, 0, -1, 2)):
        assert torch.equal(got[f], tsal.keystream(KEY, 1 + off, 2, 1,
                                                  "cpu")[0])


def test_s1_golden_keystream(lib):
    """The reference's qhasm keystream (tools/golden/salsa20_golden.bin):
    key bytes 0..31, nonce 0, the first 1 KB."""
    golden = (cuda_host_build.ROOT / "tools" / "golden"
              / "salsa20_golden.bin").read_bytes()
    got = _s1(lib, bytes(range(32)), None, 0, None, 1, 16)
    assert got.numpy().tobytes() == golden[:1024]
