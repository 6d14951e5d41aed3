"""The device Gaussian's CUDA sources (nfllib_tpu_torch/csrc/
gaussian_fixed.cu, S3, and gaussian_exact.cu, S4, with the shared search of
gaussian_search.cuh and the Salsa20 block of salsa20_block.cuh) compiled
with g++ for the host against tests/cuda_host_mock.h, and their C entry
points held, exact, to the plain twins (prng/device_sampling.py:
gaussian_fixed_plain, gaussian_exact_plain), to the JAX package's
device_gaussian / device_gaussian_exact and to the host walk on the CPU.

The mock runs each block's threads as std::threads with a barrier, so the
kernels' shared-memory keystream, the walk's doubling rounds, its two
instances (shared or global scratch), the selection and the fill count
run as written; that nvcc accepts them and their speed stay with
chip_smoke.py.  The search stage on given start positions (planted
barrier prefixes, sigma 250's table past 48 KB) runs through a small
harness around gaussian_search.cuh's count_le, the search S3 and S4 call.
Without g++ the tests skip.
"""
import ctypes

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.prng import device_sampling as jdev
from nfllib_tpu.prng import sampling as jsamp
from nfllib_tpu.prng.gaussian import FastGaussianNoise as JFastGaussianNoise
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import device_sampling as tdev
from nfllib_tpu_torch.prng import salsa20 as tsal
from nfllib_tpu_torch.prng import sampling
from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
from nfllib_tpu_torch.prng.salsa20 import Salsa20Stream

import cuda_host_build

P, I32, I64, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_ulonglong)
KEY = bytes(range(100, 132))
CAP = 232448                 # the card's shared memory a block (sm_90)
WRAP = (1 << 64) - 2

SEARCH_HARNESS = r'''
#include "MOCK"
#include "gaussian_search.cuh"

// base + count_le at start positions of keystream rows: the search of
// S3 and S4 on given words, one call a sample
template <class W>
static void run(const W* words, long long stride, const int* starts,
                int rows, int samples, int wp, const uint16_t* bw, int nb,
                int base, int* out) {
  const int steps = nfl_gauss::search_steps(nb);
  for (long long i = 0; i < static_cast<long long>(rows) * samples; ++i)
    out[i] = base + nfl_gauss::count_le(
        words + (i / samples) * stride + starts[i], bw, nb, wp, steps);
}

extern "C" void search_at(const void* words, int in_bits, long long stride,
                          const int* starts, int rows, int samples, int wp,
                          const uint16_t* bw, int nb, int base, int* out) {
  if (in_bits == 8)
    run(static_cast<const uint8_t*>(words), stride, starts, rows, samples,
        wp, bw, nb, base, out);
  else
    run(static_cast<const uint16_t*>(words), stride, starts, rows, samples,
        wp, bw, nb, base, out);
}
'''


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = cuda_host_build.build(
        tmp_path_factory.mktemp("gaussian_host"),
        ("salsa20_block.cuh", "gaussian_search.cuh", "gaussian_fixed.cu",
         "gaussian_exact.cu"), ("gaussian_fixed.cu", "gaussian_exact.cu"),
        {"search_harness.cpp": SEARCH_HARNESS})
    lib.nfl_gaussian_fixed.argtypes = [P, P, U64, P, P, I32, I32, I32, I32,
                                       P, I32, I32, P, I32, I32, P, P]
    lib.nfl_gaussian_exact_plan.argtypes = [I32] * 6 + [I64, P]
    lib.nfl_gaussian_exact_plan.restype = None
    lib.nfl_gaussian_exact.argtypes = [P, P, U64] + [I32] * 6 + [P] * 6 \
        + [I32, I32, I64, P, I32, I32] + [P] * 3 + [I64, P]
    lib.search_at.argtypes = [P, I32, I64, P, I32, I32, I32, P, I32, I32, P]
    lib.search_at.restype = None
    return lib


def _p(t):
    return P(None if t is None else t.data_ptr())


def _key(key):
    return (ctypes.c_uint32 * 8)(*np.frombuffer(key, dtype="<u4"))


def _nonce(nonce):
    """(device word or None, host addend), as the wrappers pass them"""
    if isinstance(nonce, torch.Tensor):
        return nonce, 0
    return None, nonce & ((1 << 64) - 1)


def _fg(sigma=4.0, in_bits=8, lu_depth=2, security=128, samples=1 << 10):
    return FastGaussianNoise(sigma, security, samples, in_bits=in_bits,
                             lu_depth=lu_depth)


def _jfg(sigma=4.0, in_bits=8, lu_depth=2, security=128, samples=1 << 10):
    return JFastGaussianNoise(sigma, security, samples, in_bits=in_bits,
                              lu_depth=lu_depth)


def _u(t, ring):
    return t.numpy().view(ring.dtype)


# ---------------------------------------------------------------------------
# S3: the fixed-consumption Gaussian, F samplers a launch
# ---------------------------------------------------------------------------

def _s3(lib, ring, fg, nonce, draws):
    """the C entry point on CPU tensors, as _kernels.GAUSSIAN_FIXED calls
    it: draws = ((offset, amp), ...) -> [F, m, n]"""
    bw = tdev.gaussian_tables(fg, "cpu").bw
    p = ring.context().to("cpu").p_col.reshape(-1).contiguous()
    out = torch.empty((len(draws), ring.nmoduli, ring.degree),
                      dtype=ring.torch_dtype)
    nonce_t, nonce_add = _nonce(nonce)
    offs = (ctypes.c_longlong * len(draws))(*(o for o, _ in draws))
    amps = (ctypes.c_longlong * len(draws))(*(a for _, a in draws))
    lib.mock_launches()
    assert lib.nfl_gaussian_fixed(
        _key(KEY), _p(nonce_t), nonce_add, offs, amps, len(draws),
        ring.degree, fg.in_bits, fg.word_precision, _p(bw), bw.shape[0],
        fg.base_value, _p(p), ring.nmoduli, out.element_size(), _p(out),
        None) == 0
    assert lib.mock_launches() == 1          # F samplers, one launch
    return out


def _s3_twin(ring, fg, nonce, draws):
    return tdev.device_gaussians(
        ring, KEY, nonce, tuple((o, sampling.gaussian(fg, a))
                                for o, a in draws), "cpu")


@pytest.mark.parametrize("limb,degree,bits,in_bits,amp", [
    ("u32", 1024, 510, 8, 1), ("u32", 512, 90, 16, 2), ("u16", 512, 28, 8, 2),
    ("u64", 1024, 496, 8, 2), ("u64", 256, 124, 16, 1)])
def test_s3_fixed_gaussian_matches_twin(lib, limb, degree, bits, in_bits,
                                        amp):
    """One sampler: the whole output (keystream in shared memory, search,
    amp, the p + v encoding in every channel, each storage width) against
    device_gaussian on the CPU (S3's twin) at the same (key, nonce)."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    fg = _fg(in_bits=in_bits)
    got = _s3(lib, ring, fg, 11, ((0, amp),))[0]
    want = tdev.device_gaussian(ring, KEY, 11, sampling.gaussian(fg, amp),
                                "cpu")
    assert torch.equal(got, want)
    signed = got[0].to(torch.int64)
    p0 = int(ring.moduli[0])
    signed = torch.where(signed > p0 // 2, signed - p0, signed)
    assert bool((signed != 0).any()) and bool((signed % amp == 0).all())


@pytest.mark.parametrize("limb,degree,bits,sigma,in_bits", [
    ("u16", 256, 28, 4.0, 8), ("u32", 1024, 60, 4.0, 16),
    ("u64", 512, 124, 4.0, 8), ("u32", 256, 60, 250.0, 8),
    ("u64", 256, 124, 250.0, 8)])
def test_s3_three_samplers_match_twin_and_jax(lib, limb, degree, bits,
                                              sigma, in_bits):
    """F = 3 with amps (1, 2, 2) at offsets 0, 1, 2 (the encryption's u,
    e1, e2): S3 == the twin == three calls of the JAX package's
    device_gaussian at nonce, nonce + 1, nonce + 2.  Sigma 250's barrier
    table does not fit in shared memory and is read from global memory."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    fg, jfg = _fg(sigma, in_bits), _jfg(sigma, in_bits)
    draws = ((0, 1), (1, 2), (2, 2))
    got = _s3(lib, ring, fg, 7, draws)
    assert torch.equal(got, _s3_twin(ring, fg, 7, draws))
    jring = nfl.ring_from_modulus(limb, degree, bits)
    for f, (off, amp) in enumerate(draws):
        want = jdev.device_gaussian(jring, KEY, 7 + off,
                                    jsamp.gaussian(jfg, amp))
        np.testing.assert_array_equal(_u(got[f], ring), np.asarray(want))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_s3_nonce_wrap(lib, as_tensor):
    """Offsets across 2^64: the samplers at 2^64 - 2, 2^64 - 1 and 0, the
    nonce as a host int or as a device word (plus the host addend 0)."""
    ring = tnfl.ring_from_modulus("u32", 256, 60)
    fg = _fg()
    nonce = torch.tensor(-2, dtype=torch.int64) if as_tensor else WRAP
    draws = ((0, 1), (1, 2), (2, 2))
    got = _s3(lib, ring, fg, nonce, draws)
    assert torch.equal(got, _s3_twin(ring, fg, nonce, draws))
    for f, (off, amp) in enumerate(draws):
        alone = _s3(lib, ring, fg, (WRAP + off) % (1 << 64), ((0, amp),))
        assert torch.equal(got[f], alone[0])


def test_s3_more_samplers_than_a_launch_takes_is_refused(lib):
    ring = tnfl.ring_from_modulus("u32", 256, 60)
    fg = _fg()
    bw = tdev.gaussian_tables(fg, "cpu").bw
    p = ring.context().to("cpu").p_col.reshape(-1).contiguous()
    out = torch.empty((9, 2, 256), dtype=torch.int32)
    offs = (ctypes.c_longlong * 9)(*range(9))
    for samplers, in_bits, nbytes in ((9, 8, 4), (0, 8, 4), (1, 12, 4),
                                      (1, 8, 3)):
        assert lib.nfl_gaussian_fixed(
            _key(KEY), None, 0, offs, offs, samplers, 256, in_bits,
            fg.word_precision, _p(bw), bw.shape[0], fg.base_value, _p(p), 2,
            nbytes, _p(out), None) == 1


# ---------------------------------------------------------------------------
# S4: the stream-exact Gaussian (walk + selection), and its search stage
# ---------------------------------------------------------------------------

def _exact_args(ring, fg):
    wp = fg.word_precision
    innoise = int(np.float32(ring.degree) * np.float32(fg.innoise_multiplier))
    nblocks = -(-ring.degree // max(1, (innoise - wp) // wp))
    return innoise, nblocks


def _plan(lib, ring, fg, cap=CAP):
    innoise, nblocks = _exact_args(ring, fg)
    out = (ctypes.c_longlong * 3)()
    lib.nfl_gaussian_exact_plan(ring.degree, innoise, nblocks, fg.in_bits,
                                fg.word_precision, len(fg.barrier_words),
                                cap, out)
    return bool(out[0]), int(out[1]), int(out[2])


def _s4(lib, ring, fg, nonce, amp, cap=CAP):
    """the C entry point on CPU tensors, as _kernels.GAUSSIAN_EXACT calls
    it -> ([m, n] residues, int64 [2] (fills, nonce + fills))"""
    t = tdev.gaussian_tables(fg, "cpu", exact=True)
    p = ring.context().to("cpu").p_col.reshape(-1).contiguous()
    innoise, nblocks = _exact_args(ring, fg)
    out = torch.empty(ring.shape, dtype=ring.torch_dtype)
    fills = torch.empty(2, dtype=torch.int64)
    scratch = torch.empty(_plan(lib, ring, fg, cap)[2], dtype=torch.uint8)
    deep = fg.lu_depth == 2
    nonce_t, nonce_add = _nonce(nonce)
    lib.mock_launches()
    assert lib.nfl_gaussian_exact(
        _key(KEY), _p(nonce_t), nonce_add, ring.degree, innoise, nblocks,
        fg.in_bits, fg.word_precision, fg.lu_depth, _p(t.luf), _p(t.luv),
        _p(t.slot if deep else None), _p(t.V2 if deep else None),
        _p(t.F2 if deep else None), _p(t.bw), t.bw.shape[0], fg.base_value,
        amp, _p(p), ring.nmoduli, out.element_size(), _p(out), _p(fills),
        _p(scratch), cap, None) == 0
    assert lib.mock_launches() == 2          # walk, then selection
    return out, fills


def _twin(ring, fg, nonce, amp):
    return tdev._gaussian_exact(ring, KEY, nonce, sampling.gaussian(fg, amp),
                                "cpu", None)


def _host(ring, fg, nonce, amp):
    """the host walk at (KEY, nonce) -> (residues, fills)"""
    st = Salsa20Stream(KEY, nonce)
    want = sampling.sample_gaussian(ring, st, sampling.gaussian(fg, amp))
    return want, (st.nonce - nonce) % (1 << 64)


@pytest.mark.parametrize("limb,degree,bits,sigma,in_bits,lu_depth,amp", [
    ("u32", 1024, 60, 4.0, 8, 2, 1), ("u32", 512, 60, 4.0, 16, 2, 2),
    ("u16", 512, 28, 3.2, 8, 1, 2), ("u64", 512, 124, 4.0, 16, 1, 1),
    ("u64", 256, 124, 250.0, 8, 2, 2), ("u32", 4096, 510, 4.0, 8, 2, 2)])
def test_s4_matches_twin_host_walk_and_jax(lib, limb, degree, bits, sigma,
                                           in_bits, lu_depth, amp):
    """S4's residues and fills == its twin's == the host walk's == the
    JAX package's device_gaussian_exact, over limbs, in_bits, lu_depth,
    sigma (250: 6,000+ barriers, the table in global memory), amp and
    n up to 2^12 (the walk in shared memory)."""
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    fg = _fg(sigma, in_bits, lu_depth)
    assert _plan(lib, ring, fg)[0]
    got, fills = _s4(lib, ring, fg, 5, amp)
    tv, tf = _twin(ring, fg, 5, amp)
    assert torch.equal(got, tv) and torch.equal(fills, tf)
    want, hf = _host(ring, fg, 5, amp)
    np.testing.assert_array_equal(_u(got, ring), want)
    assert int(fills[0]) == hf and int(fills[1]) == 5 + hf
    if degree <= 1024:          # the JAX walk costs seconds a call here
        jv, jf = jdev.device_gaussian_exact(
            nfl.ring_from_modulus(limb, degree, bits), KEY, 5,
            jsamp.gaussian(_jfg(sigma, in_bits, lu_depth), amp), True)
        np.testing.assert_array_equal(_u(got, ring), np.asarray(jv))
        assert int(jf) == hf


def _demo_fg(jax=False):
    """apps/lwe.py's sampler (make_gaussian_prng(samples=256)): 18 words a
    full-precision sample, fills of 2, 4, 9 and 18 words at n = 2 .. 16"""
    if jax:
        from nfllib_tpu.apps import lwe
    else:
        from nfllib_tpu_torch.apps import lwe
    return lwe.make_gaussian_prng(samples=256)


# (sampler, limb, n): the demo sampler on every tier, lu_depth 1 (whose
# search meets INT32_MIN words at n = 2) and in_bits 16; the demo's draws at
# n = 8 and 16 are also the host walk's
SMALL_BITS = {"u16": 28, "u32": 60, "u64": 124}
SMALL_CASES = ([("demo", limb, n) for limb in ("u16", "u32", "u64")
                for n in (2, 4, 8, 16)]
               + [("depth1", "u32", 2), ("depth1", "u32", 4),
                  ("in_bits16", "u32", 4), ("in_bits16", "u64", 8)])
SMALL_SAMPLERS = {"depth1": (3.2, 8, 1, 80, 256),
                  "in_bits16": (4.0, 16, 2, 128, 1 << 10)}


@pytest.mark.parametrize("sampler,limb,n", SMALL_CASES)
def test_s4_below_fill_size_matches_twin_and_jax(lib, sampler, limb, n):
    """Fills of innoise <= word_precision words, where the JAX package reads
    a sample's words at negative positions (normalised once, else
    INT32_MIN; clamped into F2 / V2): S4's residues and fills == its
    twin's == the JAX package's device_gaussian_exact, at amp 2."""
    if sampler == "demo":
        fg, jfg = _demo_fg(), _demo_fg(jax=True)
    else:
        fg, jfg = _fg(*SMALL_SAMPLERS[sampler]), _jfg(*SMALL_SAMPLERS[sampler])
    ring = tnfl.ring_from_modulus(limb, n, SMALL_BITS[limb])
    assert _exact_args(ring, fg)[0] <= fg.word_precision
    got, fills = _s4(lib, ring, fg, 7, 2)
    tv, tf = _twin(ring, fg, 7, 2)
    assert torch.equal(got, tv) and torch.equal(fills, tf)
    jv, jf = jdev.device_gaussian_exact(
        nfl.ring_from_modulus(limb, n, SMALL_BITS[limb]), KEY, 7,
        jsamp.gaussian(jfg, 2), True)
    np.testing.assert_array_equal(_u(got, ring), np.asarray(jv))
    assert int(jf) == int(fills[0]) and int(fills[1]) == 7 + int(jf)
    if sampler == "demo" and n >= 8:
        want, hf = _host(ring, fg, 7, 2)
        np.testing.assert_array_equal(_u(got, ring), want)
        assert int(fills[0]) == hf


@pytest.mark.parametrize("in_bits", [8, 16])
def test_s4_global_instance_matches_twin(lib, in_bits):
    """A shared-memory cap below the walk's need sends the same kernel to
    its instance with 32-bit indices and global scratch: identical
    residues and fills."""
    ring = tnfl.ring_from_modulus("u32", 4096, 60)
    fg = _fg(in_bits=in_bits)
    cap = 16 * 1024
    assert _plan(lib, ring, fg)[0] and not _plan(lib, ring, fg, cap)[0]
    got, fills = _s4(lib, ring, fg, 9, 2, cap)
    tv, tf = _twin(ring, fg, 9, 2)
    assert torch.equal(got, tv) and torch.equal(fills, tf)
    assert torch.equal(got, _s4(lib, ring, fg, 9, 2)[0])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_s4_nonce_wrap_and_fills_chain_like_host(lib, as_tensor):
    """Three exact samplers (amps 1, 2, 2) chained through S4's nonce +
    fills word, from 2^64 - 2 (the fills cross the wrap), equal three
    sequential host draws on one stream, as the exact encryption chains
    them; the start nonce as a host int or a device word."""
    ring = tnfl.ring_from_modulus("u32", 256, 60)
    fg = _fg(250.0)           # several fills a draw at this degree
    st = Salsa20Stream(KEY, WRAP)
    nonce = torch.tensor(-2, dtype=torch.int64) if as_tensor else WRAP
    total = 0
    for amp in (1, 2, 2):
        want = sampling.sample_gaussian(ring, st, sampling.gaussian(fg, amp))
        got, fills = _s4(lib, ring, fg, nonce, amp)
        np.testing.assert_array_equal(_u(got, ring), want)
        tv, tf = _twin(ring, fg, nonce, amp)
        assert torch.equal(got, tv) and torch.equal(fills, tf)
        total += int(fills[0])
        assert (int(fills[1]) - WRAP - total) % (1 << 64) == 0
        nonce = fills[1]
    assert (st.nonce - WRAP) % (1 << 64) == total
    assert total > 3                           # the host refilled


@pytest.mark.parametrize("in_bits", [8, 16])
def test_s4_large_degree_takes_global_instance(lib, in_bits):
    """n = 2^15: the walk outgrows the card's 227 KB of shared memory, so
    S4 takes its global-scratch instance at the real cap; still the host
    walk bit for bit (a few seconds in the mock)."""
    ring = tnfl.ring_from_modulus("u32", 1 << 15, 60)
    fg = _fg(in_bits=in_bits)
    assert not _plan(lib, ring, fg)[0]
    got, fills = _s4(lib, ring, fg, 3, 1)
    want, hf = _host(ring, fg, 3, 1)
    np.testing.assert_array_equal(_u(got, ring), want)
    assert int(fills[0]) == hf


def test_s4_refuses_what_it_does_not_take(lib):
    fg = _fg()
    t = tdev.gaussian_tables(fg, "cpu", exact=True)
    p = torch.ones(2, dtype=torch.int64)
    out = torch.empty((2, 64), dtype=torch.int32)
    fills = torch.empty(2, dtype=torch.int64)
    wp = fg.word_precision
    for in_bits, depth, innoise, nbytes, slot in (
            (12, 2, 80, 4, t.slot), (8, 3, 80, 4, t.slot),
            (8, 2, 0, 4, t.slot), (8, 2, 80, 3, t.slot),
            (8, 2, 80, 4, None)):
        assert lib.nfl_gaussian_exact(
            _key(KEY), None, 0, 64, innoise, 2, in_bits, wp, depth,
            _p(t.luf), _p(t.luv), _p(slot), _p(t.V2), _p(t.F2), _p(t.bw),
            t.bw.shape[0], fg.base_value, 1, _p(p), 2, nbytes, _p(out),
            _p(fills), None, CAP, None) == 1


@pytest.mark.parametrize("sigma,in_bits,lu_depth", [
    (4.0, 8, 2), (4.0, 16, 2), (3.2, 8, 1), (250.0, 8, 2)])
def test_search_stage_at_start_positions(lib, sigma, in_bits, lu_depth):
    """The search S3 and S4 share (gaussian_search.cuh's count_le): base +
    #{barriers <= r} at given start positions of several keystream rows,
    against the twin's search on the gathered words; sigma 250 has 6000+
    barriers.  Rows are chosen so some starts land on words at barrier
    prefixes (r equal to a barrier in its leading words)."""
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
    got = torch.empty(tuple(starts.shape), dtype=torch.int32)
    lib.search_at(_p(stream), in_bits, stream.shape[1] * 32 // in_bits,
                  _p(starts), rows, starts.shape[1], wp, _p(bw), bw.shape[0],
                  fg.base_value, _p(got))
    r = torch.stack([torch.gather(words, 1, starts.long() + j)
                     for j in range(wp)], dim=-1)
    want = fg.base_value + tdev._count_barriers_le(
        r.reshape(-1, wp), bw64, bw.shape[0]).reshape(starts.shape)
    assert torch.equal(got.to(torch.int64), want)
    assert torch.equal(got, tdev.barrier_count_plain(
        stream, in_bits, wp, bw, fg.base_value, starts=starts))
    assert int(got[1, 0]) >= fg.base_value + 1      # r == barrier 0
