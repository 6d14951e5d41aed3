"""The keystream kernel's CUDA source (nfllib_tpu_torch/csrc/salsa20.cu, S1,
with salsa20_block.cuh) compiled with g++ for the host against
tests/cuda_host_mock.h, and its C entry points held to the plain twins on
the CPU, exact: the raw keystream (nfl_salsa20) to prng/salsa20.py:keystream,
and the sampler instances (nfl_salsa20_sampler, through the port's own
wrapper `_kernels.Salsa20SamplerKernel`) to device_uniform_plain,
device_non_uniform_plain and device_zo_plain, to the JAX package's
device_uniform / device_non_uniform / device_zo and to the host samplers.
The Gaussian's kernels S3 and S4 have theirs in
test_torch_gaussian_kernels.py.

The mock runs each block's threads as std::threads, so S1's nonce
arithmetic (device base, host addend, offsets, the wrap at 2^64), its
partial last blocks and its channel groups (grid.y) run as written; that
nvcc accepts it and its speed stay with chip_smoke.py.  Without g++ the
tests skip.
"""
import ctypes

import numpy as np
import pytest
import torch

from nfllib_tpu.prng import device_sampling as jdev
from nfllib_tpu.prng import sampling as jsamp
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import _kernels
from nfllib_tpu_torch.prng import device_sampling as tdev
from nfllib_tpu_torch.prng import salsa20 as tsal
from nfllib_tpu_torch.prng import sampling as tsamp

import cuda_host_build
from conftest import make_ring as make_jring

P, I32, I64, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_ulonglong)
KEY = bytes(range(100, 132))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = cuda_host_build.build(tmp_path_factory.mktemp("sampling_host"),
                                ("launch.cuh", "salsa20_block.cuh",
                                 "salsa20.cu"),
                                ("salsa20.cu",))
    lib.nfl_salsa20.argtypes = [P, P, U64, P, I32, I64, P, P]
    lib.nfl_salsa20_sampler.argtypes = _kernels.SALSA20_SAMPLER_ARGTYPES
    return lib


class HostSampler(_kernels.Salsa20SamplerKernel):
    """The port's wrapper of an S1 sampler instance over the host-built
    library and CPU tensors."""

    def __init__(self, lib, epilogue):
        super().__init__(f"salsa20_{epilogue}_host", epilogue)
        self.lib = lib

    def _on_card(self, t):
        return t.device.type == "cpu"

    def _launch(self, x, entry, *args):
        assert getattr(self.lib, entry)(*args, None) == 0
        assert self.lib.mock_launches() == 1
        self.launches += 1


@pytest.fixture(scope="module")
def samplers(lib):
    return {e: HostSampler(lib, e) for e in ("uniform", "non_uniform", "zo")}


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


# ---------------------------------------------------------------------------
# the sampler instances: uniform, non-uniform, ZO
# ---------------------------------------------------------------------------

# (limb, degree, aggregated modulus bits): u16 at 16 bytes (m = 1, a partial
# last block) and 32; u32 at a block a ring and at three channels; u64 at
# n = 8 (a block a channel) and 32
RINGS = [("u16", 8, 14), ("u16", 8, 28), ("u16", 64, 28), ("u32", 8, 60),
         ("u32", 64, 90), ("u64", 8, 124), ("u64", 32, 62)]
# an int nonce, a 0-d tensor nonce (the bit pattern of 2^64 - 2: the
# wrap), an int nonce at the wrap
NONCES = [("int", 3), ("tensor", (1 << 64) - 2), ("int", (1 << 64) - 2)]


def _nonce(kind, value):
    return torch.tensor(tsal._signed64(value), dtype=torch.int64) \
        if kind == "tensor" else value


def _u(t, ring):
    return t.numpy().view(ring.dtype)


def _check_all(got, twin, jax_out, host, ring):
    """the kernel's residues equal the twin's, the JAX device tier's and
    the host sampler's"""
    assert got.dtype == ring.torch_dtype and got.shape == ring.shape
    assert torch.equal(got, twin)
    np.testing.assert_array_equal(_u(got, ring), np.asarray(jax_out))
    np.testing.assert_array_equal(_u(got, ring), host)


@pytest.mark.parametrize("limb,degree,agg", RINGS)
@pytest.mark.parametrize("kind,nonce", NONCES)
def test_s1_uniform(samplers, limb, degree, agg, kind, nonce):
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    p = ring.context().to("cpu").p_col
    got = samplers["uniform"](KEY, _nonce(kind, nonce), p, degree,
                              ring.torch_dtype, *tdev._uniform_consts(ring))
    _check_all(got, tdev.device_uniform_plain(ring, KEY, nonce, "cpu"),
               jdev.device_uniform(make_jring(degree, agg, limb), KEY,
                                   nonce),
               tsamp.sample_uniform(ring, tsal.Salsa20Stream(KEY, nonce)),
               ring)


def _bounds(ring):
    """(ub, amp) cases: a small bound at amps 1 and 3, and ub = p - 1 of the
    smallest modulus at amp 1 and, where span * amp stays below 2^63 (the
    twin's int64), 3"""
    top = min(int(q) for q in ring.moduli) - 1
    return [(5, 1), (5, 3), (top, 1)] + ([(top, 3)] if ring.limb != "u64"
                                         else [])


# (limb, degree, aggregated modulus bits, block): channel blocks whose
# first limb lies off the 64-byte block grid (u16 n = 8 and 4, u32 n = 8
# and 4, u64 n = 4 and 2; at u16 n = 4 and u64 n = 4 a run also lies off
# the 16-byte grid) and on it (u32 n = 64, u64 n = 8); u32 n = 8 blocks
# [1:257] and [2:258] take 129 and 128 keystream blocks (a partial first
# and last run, or none: two CTAs of 128 threads, or one); u32 n = 4096
# block [1:2] 256 blocks, where a draw from the stream's start would take
# 512
OFFSET_CASES = [("u16", 8, 28, (1, 2)), ("u16", 4, 28, (1, 2)),
                ("u32", 8, 150, (3, 5)), ("u32", 4, 150, (1, 4)),
                ("u32", 64, 90, (1, 3)), ("u64", 8, 248, (1, 3)),
                ("u64", 4, 248, (1, 3)), ("u64", 2, 248, (3, 4)),
                ("u32", 8, 30 * 258, (1, 257)),
                ("u32", 8, 30 * 258, (2, 258)),
                ("u32", 4096, 60, (1, 2))]


@pytest.mark.parametrize("limb,degree,agg,block", OFFSET_CASES)
@pytest.mark.parametrize("kind,nonce", NONCES[:2])
def test_s1_uniform_at_an_offset(samplers, lib, limb, degree, agg, block,
                                 kind, nonce):
    """S1's uniform instance on a channel block, its stream read from limb
    first * n on: equal to the twin on the block, to the whole ring's
    draw's rows and to the host stream's limbs there (Python and native
    tiers), the stream's nonce moved once; its grid holds only the
    keystream blocks those limbs lie in."""
    whole = tnfl.ring_from_modulus(limb, degree, agg)
    ring = whole.channel_block(*block)
    isz = np.dtype(ring.dtype).itemsize
    offset = ring.first * degree
    p = ring.context().to("cpu").p_col
    lib.mock_grid_x.restype = ctypes.c_uint
    got = samplers["uniform"](KEY, _nonce(kind, nonce), p, degree,
                              ring.torch_dtype, *tdev._uniform_consts(ring),
                              offset=offset)
    assert got.dtype == ring.torch_dtype and got.shape == ring.shape
    assert torch.equal(got, tdev.device_uniform_plain(ring, KEY, nonce,
                                                      "cpu"))
    assert torch.equal(got, tdev.device_uniform_plain(whole, KEY, nonce,
                                                      "cpu")[block[0]:
                                                             block[1]])
    for native in (True, False):
        stream = tsal.Salsa20Stream(KEY, nonce)
        if not native:
            stream._native = None
        np.testing.assert_array_equal(_u(got, ring),
                                      tsamp.sample_uniform(ring, stream))
        assert stream.nonce == (nonce + 1) % (1 << 64)
    first_byte = offset * isz
    last_byte = (offset + ring.nmoduli * degree) * isz
    blocks = -(-last_byte // 64) - first_byte // 64
    assert lib.mock_grid_x() == -(-blocks // 128)
    if block in ((1, 257), (2, 258)):
        assert blocks == (129 if block[0] == 1 else 128)


def test_s1_offset_is_the_uniforms(samplers):
    """The non-uniform and ZO instances read n limbs whatever the channels
    and take no offset; no instance takes a negative one."""
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    p = ring.context().to("cpu").p_col
    for name, consts in (("non_uniform", tdev._non_uniform_consts(ring, 5,
                                                                  1)),
                         ("zo", (127,))):
        before = samplers[name].launches
        with pytest.raises(ValueError, match="offset"):
            samplers[name](KEY, 0, p, 64, torch.int32, *consts, offset=64)
        assert samplers[name].launches == before
    with pytest.raises(ValueError, match="offset"):
        samplers["uniform"](KEY, 0, p, 64, torch.int32,
                            *tdev._uniform_consts(ring), offset=-1)


@pytest.mark.parametrize("limb,degree,agg", RINGS)
@pytest.mark.parametrize("kind,nonce", NONCES[:2])
def test_s1_non_uniform(samplers, limb, degree, agg, kind, nonce):
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    jring = make_jring(degree, agg, limb)
    p = ring.context().to("cpu").p_col
    for ub, amp in _bounds(ring):
        mode = tsamp.non_uniform(ub, amp)
        got = samplers["non_uniform"](
            KEY, _nonce(kind, nonce), p, degree, ring.torch_dtype,
            *tdev._non_uniform_consts(ring, ub, amp))
        _check_all(got, tdev.device_non_uniform_plain(ring, KEY, nonce, mode,
                                                      "cpu"),
                   jdev.device_non_uniform(jring, KEY, nonce,
                                           jsamp.non_uniform(ub, amp)),
                   tsamp.sample_non_uniform(
                       ring, tsal.Salsa20Stream(KEY, nonce), mode), ring)
    with pytest.raises(ValueError):
        tdev._non_uniform_consts(ring, min(int(q) for q in ring.moduli), 1)


@pytest.mark.parametrize("limb,degree,agg", RINGS)
@pytest.mark.parametrize("kind,nonce", NONCES[:2])
def test_s1_zo(samplers, limb, degree, agg, kind, nonce):
    """rho 0, 127 and 255; n = 8 stores a partial last block"""
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    jring = make_jring(degree, agg, limb)
    p = ring.context().to("cpu").p_col
    for rho in (0, 127, 255):
        mode = tsamp.ZO_dist(rho)
        got = samplers["zo"](KEY, _nonce(kind, nonce), p, degree,
                             ring.torch_dtype, rho)
        _check_all(got, tdev.device_zo_plain(ring, KEY, nonce, mode, "cpu"),
                   jdev.device_zo(jring, KEY, nonce, jsamp.ZO_dist(rho)),
                   tsamp.sample_zo(ring, tsal.Salsa20Stream(KEY, nonce),
                                   mode), ring)


@pytest.mark.parametrize("epilogue", ["non_uniform", "zo"])
@pytest.mark.parametrize("limb,degree,agg", [("u32", 64, 150),
                                             ("u32", 128, 510),
                                             ("u32", 1 << 15, 60)])
def test_s1_channel_groups(samplers, epilogue, limb, degree, agg):
    """The mock's card has 2 SMs, so grid.y splits 5 channels at n = 64 into
    groups of 2 (the last one short) and 17 at n = 128 into groups of 5
    (the last one short); at u32 2^15 the grid covers the SMs without
    groups."""
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    p = ring.context().to("cpu").p_col
    if epilogue == "zo":
        mode, consts = tsamp.ZO_dist(200), (200,)
        twin = tdev.device_zo_plain(ring, KEY, 11, mode, "cpu")
    else:
        mode = tsamp.non_uniform(9, 5)
        consts = tdev._non_uniform_consts(ring, 9, 5)
        twin = tdev.device_non_uniform_plain(ring, KEY, 11, mode, "cpu")
    got = samplers[epilogue](KEY, 11, p, degree, ring.torch_dtype, *consts)
    assert torch.equal(got, twin)


def test_s1_sampler_wrapper(samplers):
    """One launch a call; the wrapper refuses a degree that is not a power
    of two, a dtype that is not a storage dtype, strided moduli, a key of
    the wrong length and a tensor nonce of another dtype, launching
    nothing; the card's wrappers refuse CPU tensors."""
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    p = ring.context().to("cpu").p_col
    k = samplers["uniform"]
    before = k.launches
    k(KEY, 0, p, 64, torch.int32, *tdev._uniform_consts(ring))
    assert k.launches == before + 1
    wide = torch.zeros((2, 2), dtype=torch.int64)
    for args in ((KEY, 0, p, 48, torch.int32), (KEY, 0, p, 64, torch.uint8),
                 (KEY, 0, wide[:, 0], 64, torch.int32),
                 (KEY[:16], 0, p, 64, torch.int32),
                 (KEY, torch.zeros((), dtype=torch.int32), p, 64,
                  torch.int32)):
        with pytest.raises(ValueError):
            k(*args, 1)
    assert k.launches == before + 1
    for kern in (_kernels.SALSA20_UNIFORM, _kernels.SALSA20_NON_UNIFORM,
                 _kernels.SALSA20_ZO):
        with pytest.raises(ValueError):
            kern(KEY, 0, p, 64, torch.int32, 1)


def test_s1_dispatch_on_the_cpu_runs_the_twins(monkeypatch):
    """device_uniform / device_non_uniform / device_zo on CPU tensors are
    their twins and launch nothing, even with the kernels' wrappers
    replaced by ones that fail."""
    ring = tnfl.ring_from_modulus("u16", 64, 28)

    def boom(*args):
        raise AssertionError("a kernel ran on a CPU tensor")
    for name in ("SALSA20_UNIFORM", "SALSA20_NON_UNIFORM", "SALSA20_ZO"):
        monkeypatch.setattr(_kernels, name, boom)
    assert torch.equal(tdev.device_uniform(ring, KEY, 2, "cpu"),
                       tdev.device_uniform_plain(ring, KEY, 2, "cpu"))
    mode = tsamp.non_uniform(3, 2)
    assert torch.equal(tdev.device_non_uniform(ring, KEY, 2, mode, "cpu"),
                       tdev.device_non_uniform_plain(ring, KEY, 2, mode,
                                                     "cpu"))
    mode = tsamp.ZO_dist(0x40)
    assert torch.equal(tdev.device_zo(ring, KEY, 2, mode, "cpu"),
                       tdev.device_zo_plain(ring, KEY, 2, mode, "cpu"))
