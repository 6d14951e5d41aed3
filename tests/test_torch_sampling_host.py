"""The device samplers' CUDA sources (nfllib_tpu_torch/csrc/salsa20.cu, S1,
and barrier_count.cu, S2) compiled with g++ for the host against
tests/cuda_host_mock.h, and their C entry points held to the plain twins
(prng/salsa20.py:keystream, prng/device_sampling.py), exact, on the CPU.

The mock runs each block's threads as std::threads with a barrier, so S1's
staging through shared memory, its nonce arithmetic (device base, host
addend, offsets, the wrap at 2^64) and S2's table copy, search, start
positions and per-channel encoding run as written; that nvcc accepts them
and their speed stay with chip_smoke.py.  Without g++ the tests skip.
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
                                ("salsa20.cu", "barrier_count.cu"),
                                ("salsa20.cu", "barrier_count.cu"))
    lib.nfl_salsa20.argtypes = [P, P, U64, P, I32, I64, P, P]
    lib.nfl_barrier_count.argtypes = [P, I32, I64, P, I32, I32, I32, P, I32,
                                      I32, I64, P, I32, I32, P, P]
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


def _s2(lib, words, in_bits, wp, bw, base, *, starts=None, samples=0,
        amp=1, p=None, dtype=None):
    """the C entry point on CPU tensors, as _kernels.BARRIER_COUNT calls
    it"""
    rows, length = words.shape
    if starts is not None:
        out = torch.empty(tuple(starts.shape), dtype=torch.int32)
        samples, m, nbytes = starts.shape[1], 0, 4
    else:
        p = p.reshape(-1).contiguous()
        out = torch.empty((p.shape[0], samples), dtype=dtype)
        m, nbytes = p.shape[0], out.element_size()
    lib.mock_launches()
    assert lib.nfl_barrier_count(_p(words), in_bits, length * 32 // in_bits,
                                 _p(starts), rows, samples, wp, _p(bw),
                                 bw.shape[0], base, amp, _p(p), m, nbytes,
                                 _p(out), None) == 0
    assert lib.mock_launches() == 1
    return out


def _fg(sigma=4.0, in_bits=8, lu_depth=2, security=128):
    return FastGaussianNoise(sigma, security, 1 << 10, in_bits=in_bits,
                             lu_depth=lu_depth)


@pytest.mark.parametrize("limb,degree,bits,in_bits,amp", [
    ("u32", 1024, 510, 8, 1), ("u32", 512, 90, 16, 2), ("u16", 512, 28, 8, 2),
    ("u64", 1024, 496, 8, 2), ("u64", 256, 124, 16, 1)])
def test_s2_fixed_gaussian_matches_twin(lib, limb, degree, bits, in_bits,
                                        amp):
    """The fixed-consumption Gaussian, S2's whole output (search, amp, the
    p + v encoding in every channel, each storage width), against
    device_gaussian on the CPU (S2's twin) on the same keystream."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    fg = _fg(in_bits=in_bits)
    wp, n = fg.word_precision, ring.degree
    stream = tsal.keystream(KEY, 11, (n * wp * in_bits // 8 + 63) // 64, 1,
                            "cpu")
    got = _s2(lib, stream, in_bits, wp, tdev.gaussian_tables(fg, "cpu").bw,
              fg.base_value, samples=n, amp=amp,
              p=ring.context().to("cpu").p_col, dtype=ring.torch_dtype)
    want = tdev.device_gaussian(ring, KEY, 11, gaussian(fg, amp), "cpu")
    assert torch.equal(got, want)
    signed = got[0].to(torch.int64)
    p0 = int(ring.moduli[0])
    signed = torch.where(signed > p0 // 2, signed - p0, signed)
    assert bool((signed != 0).any()) and bool((signed % amp == 0).all())


@pytest.mark.parametrize("sigma,in_bits,lu_depth", [
    (4.0, 8, 2), (4.0, 16, 2), (3.2, 8, 1), (250.0, 8, 2)])
def test_s2_counts_at_start_positions(lib, sigma, in_bits, lu_depth):
    """Count mode: base + #{barriers <= r} at given start positions of
    several keystream rows, against the twin's search on the gathered
    words; sigma 250 has 6000+ barriers, a table past 48 KB that S2 reads
    from global memory.  Rows are chosen so some starts land on words at
    barrier prefixes (r equal to a barrier in its leading words)."""
    fg = _fg(sigma, in_bits, lu_depth)
    wp = fg.word_precision
    rows, length = 3, 600
    stream = tsal.keystream(KEY, 2, (length * in_bits // 8 + 63) // 64, rows,
                            "cpu")
    bw = tdev.gaussian_tables(fg, "cpu").bw
    bw64 = bw.to(torch.int64) & 0xFFFF
    # plant barrier prefixes (and one whole barrier) in row 1
    items = stream.view(torch.uint8 if in_bits == 8 else torch.int16)
    for k, b in enumerate(range(0, bw.shape[0], max(1, bw.shape[0] // 8))):
        at = 10 + k * (wp + 3)
        take = wp if k == 0 else 1 + k % wp
        items[1, at:at + take] = bw[b, :take].to(items.dtype)
    words = tdev._item_words(stream, in_bits)
    rng = np.random.default_rng(int(sigma) + in_bits)
    starts = torch.from_numpy(rng.integers(0, length - wp, size=(rows, 257))
                              .astype(np.int32))
    starts[1, :8] = torch.tensor([10 + k * (wp + 3) for k in range(8)],
                                 dtype=torch.int32)
    got = _s2(lib, stream, in_bits, wp, bw, fg.base_value, starts=starts)
    r = torch.stack([torch.gather(words, 1, starts.long() + j)
                     for j in range(wp)], dim=-1)
    want = fg.base_value + tdev._count_barriers_le(
        r.reshape(-1, wp), bw64, bw.shape[0]).reshape(starts.shape)
    assert torch.equal(got.to(torch.int64), want)
    assert int(got[1, 0]) >= fg.base_value + 1      # r == barrier 0


def test_s2_refuses_what_it_does_not_take(lib):
    x = torch.zeros((1, 64), dtype=torch.int32)
    bw = torch.zeros((3, 2), dtype=torch.int16)
    out = torch.empty((2, 8), dtype=torch.int32)
    p = torch.ones(2, dtype=torch.int64)
    for in_bits, rows, nbytes in ((12, 1, 4), (8, 2, 4), (8, 1, 3)):
        assert lib.nfl_barrier_count(_p(x), in_bits, 256, None, rows, 8, 2,
                                     _p(bw), 3, 0, 1, _p(p), 2, nbytes,
                                     _p(out), None) == 1
