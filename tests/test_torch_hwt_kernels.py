"""The hwt samplers' CUDA source (nfllib_tpu_torch/csrc/hwt.cu: S5 for
device_hwt, S6 for device_hwt_exact, with salsa20_block.cuh) compiled
with g++ for the host against tests/cuda_host_mock.h and driven through
the port's own wrappers (_kernels.HwtFixedKernel, HwtExactKernel), held
exact to the plain twins (prng/device_sampling.py: device_hwt_plain,
device_hwt_exact_plain and their cores on given words), to the host
sampler (S6: the residues and the nonce advance) and to the JAX package's
device_hwt / device_hwt_exact on the CPU.

Each call runs in both of its instances: the fast one (S6's partial
reservoir, S5's candidates in the last CTA's shared memory) and, with a
`cap` of 0, the other (S6's many-block walk, S5's candidates read in
global memory).  The words-in instance forces what the keystream almost
never gives: ambiguous words that are rejected (the last CTA's exact
branch) and accepted (its merge of the partials), over several CTAs'
records, a tripped budget guard, and tied keys for S5's stable order,
within a segment and across two.  At n = 4096 the first launch runs
over several CTAs (S5: four segments; S6: up to 64 CTAs), so the last
CTA merges real partials, and T, the index past the last consumed word,
ends inside a CTA's range.  The mock runs each block's threads as
std::threads, so the atomics, the radix passes and the ranks run as
written; it runs the blocks of a launch one after another, so the last
CTA to take the ticket is always the grid's last block, and only the
card tests the ticket's ordering under blocks that run at once.  That
nvcc accepts the source and its speed stay with chip_smoke.py.  Without
g++ the tests skip.
"""
import numpy as np
import pytest
import torch

from nfllib_tpu.prng import device_sampling as jdev
from nfllib_tpu.prng import sampling as jsamp
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import _kernels
from nfllib_tpu_torch.prng import device_sampling as tdev
from nfllib_tpu_torch.prng import sampling as tsamp
from nfllib_tpu_torch.prng.salsa20 import Salsa20Stream

import cuda_host_build
from conftest import make_ring as make_jring

KEY = bytes(range(7, 39))
M = (1 << 64) - 1
RINGS = {"u16": (64, 28), "u32": (256, 60), "u64": (128, 124)}
H = {"one": lambda n: 1, "quarter": lambda n: n // 4, "full": lambda n: n}
# an int nonce, and a tensor one whose fills cross 2^64 - 1
NONCES = (5, -2)
CAPS = (None, 0)              # the default cap (fast), and the other


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = cuda_host_build.build(tmp_path_factory.mktemp("hwt_host"),
                                ("launch.cuh", "salsa20_block.cuh",
                                 "hwt.cu"), ("hwt.cu",))
    _kernels.set_hwt_argtypes(lib)
    return lib


def _host(cls, lib):
    """the port's wrapper `cls` over the host-built library and CPU
    tensors; `kernels` holds the kernels its last call launched"""
    class Host(cls):
        def _on_card(self, t):
            return t.device.type == "cpu"

        def _entry(self, name):
            return getattr(lib, name)

        def _run(self, p, entry, pl, args):
            state, scratch = self._workspace(p.device, None, pl.bytes)
            lib.mock_launches()
            assert getattr(lib, entry)(*args(state.data_ptr(),
                                             scratch.data_ptr()), None) == 0
            self.kernels = lib.mock_launches()
            self._last = (scratch, pl)
            self.launches += 1
            # the persistent state (the ticket, S6's reservoir) is back at
            # 0 for the next launch
            assert not bool(state.any())

    return Host(cls.__name__ + "_host")


@pytest.fixture(scope="module")
def s6(lib):
    return _host(_kernels.HwtExactKernel, lib)


@pytest.fixture(scope="module")
def s5(lib):
    return _host(_kernels.HwtFixedKernel, lib)


def _ring(limb, n=None):
    degree, agg = RINGS[limb]
    return tnfl.ring_from_modulus(limb, n or degree, agg)


def _p(ring):
    return ring.context().to("cpu").p_col


def _nonce(v):
    """(the nonce as the kernel takes it, as an int mod 2^64)"""
    if v < 0:
        return torch.tensor(v, dtype=torch.int64), v & M
    return v, v


def _u(t, ring):
    return t.numpy().view(ring.dtype)


def _words(values):
    return torch.from_numpy(np.asarray(values, dtype=np.uint64)
                            .view(np.int64).copy())


def _expect_kernels(kern, n, h, words_in, cap):
    """the call's kernels are its plan's; a cap of 0 forces the other
    instance, and S6's default cap the fast one at these sizes"""
    pl = kern.plan(n, h, words_in, cap)
    assert kern.kernels == pl.kernels
    assert pl.kernels == (2 if pl.fast or not kern.exact else 3)
    assert not (cap == 0 and pl.fast)
    assert pl.fast or not (kern.exact and cap is None)
    return pl


@pytest.mark.parametrize("hfrac", list(H))
@pytest.mark.parametrize("limb", list(RINGS))
def test_s6_matches_twin_host_and_jax(s6, limb, hfrac):
    """S6 against device_hwt_exact_plain, the host sampler (values and
    nonce advance) and, at h = n / 4, the JAX package's device_hwt_exact,
    in both instances, at an int nonce and a tensor nonce across the wrap.
    (At the other h the twin stands for the JAX package, which
    test_torch_device_sampling.py holds to it at h = 1, n / 4 and n.)"""
    ring = _ring(limb)
    n = ring.degree
    h = H[hfrac](n)
    mode = tsamp.hwt_dist(h)
    for v in NONCES:
        nonce, nonce_int = _nonce(v)
        want, wadv = tdev.device_hwt_exact_plain(ring, KEY, nonce, mode,
                                                 True, device="cpu")
        st = Salsa20Stream(KEY, nonce_int)
        host = tsamp.sample_hwt(ring, st, mode)
        np.testing.assert_array_equal(_u(want, ring), host)
        assert int(wadv) == (st.nonce - nonce_int) % (1 << 64)
        for cap in CAPS:
            got, adv = s6(KEY, nonce, _p(ring), n, h, ring.torch_dtype,
                          cap=cap)
            _expect_kernels(s6, n, h, False, cap)
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert adv.dim() == 0 and int(adv) == int(wadv)
    if hfrac == "quarter":
        jgot = jdev.device_hwt_exact(make_jring(n, *RINGS[limb][1:], limb),
                                     KEY, 5, jsamp.hwt_dist(h))
        got, _ = s6(KEY, 5, _p(ring), n, h, ring.torch_dtype)
        np.testing.assert_array_equal(_u(got, ring), np.asarray(jgot))


@pytest.mark.parametrize("hfrac", list(H))
@pytest.mark.parametrize("limb", list(RINGS))
def test_s5_matches_twin_and_jax(s5, limb, hfrac):
    """S5 against device_hwt_plain and, at h = n / 4, the JAX package's
    device_hwt (the twin stands for it at the other h), in both
    instances, at an int nonce and a tensor nonce at the wrap."""
    ring = _ring(limb)
    n = ring.degree
    h = H[hfrac](n)
    mode = tsamp.hwt_dist(h)
    for v in NONCES:
        nonce, _ = _nonce(v)
        want = tdev.device_hwt_plain(ring, KEY, nonce, mode, "cpu")
        for cap in CAPS:
            got = s5(KEY, nonce, _p(ring), n, h, ring.torch_dtype, cap=cap)
            _expect_kernels(s5, n, h, False, cap)
            assert got.dtype == want.dtype and torch.equal(got, want)
    if hfrac == "quarter":
        jgot = jdev.device_hwt(make_jring(n, *RINGS[limb][1:], limb), KEY, 5,
                               jsamp.hwt_dist(h))
        got = s5(KEY, 5, _p(ring), n, h, ring.torch_dtype)
        np.testing.assert_array_equal(_u(got, ring), np.asarray(jgot))


@pytest.mark.parametrize("h", [1, 64, 1000, 1024, 4096])
def test_many_ctas_match_twin_and_host(s5, s6, h):
    """At u32 n = 4096 the first launch runs over several CTAs (S5: four
    segments of 1024 keys; S6: 64, 8, 10, 8 and 8 CTAs at these h), whose
    last CTA merges their partials or candidates.  T = n - h ends inside a
    CTA's range at h = 1000 (fills of 125 keystream blocks).  Both
    samplers in both instances against their twins, S6 also against the
    host sampler and its advance, S5 at h = 1024 against the JAX package;
    the last call's SM ids are readable (one SM on the mock)."""
    ring = _ring("u32", 4096)
    n = ring.degree
    mode = tsamp.hwt_dist(h)
    st = Salsa20Stream(KEY, 11)
    host = tsamp.sample_hwt(ring, st, mode)
    want5 = tdev.device_hwt_plain(ring, KEY, 11, mode, "cpu")
    want6, wadv = tdev.device_hwt_exact_plain(ring, KEY, 11, mode, True,
                                              device="cpu")
    np.testing.assert_array_equal(_u(want6, ring), host)
    assert int(wadv) == st.nonce - 11
    for cap in CAPS:
        got = s5(KEY, 11, _p(ring), n, h, ring.torch_dtype, cap=cap)
        pl = _expect_kernels(s5, n, h, False, cap)
        assert pl.grid == 4 and s5.last_sms() == 1
        assert torch.equal(got, want5)
        got, adv = s6(KEY, 11, _p(ring), n, h, ring.torch_dtype, cap=cap)
        pl = _expect_kernels(s6, n, h, False, cap)
        assert pl.grid > 1 and s6.last_sms() == 1
        assert torch.equal(got, want6) and int(adv) == int(wadv)
    if h == 1024:
        jgot = jdev.device_hwt(make_jring(n, RINGS["u32"][1], "u32"), KEY,
                               11, jsamp.hwt_dist(h))
        np.testing.assert_array_equal(
            _u(s5(KEY, 11, _p(ring), n, h, ring.torch_dtype), ring),
            np.asarray(jgot))


@pytest.mark.parametrize("limb", ["u32", "u64"])
def test_plans_at_the_lwe_rings(s5, s6, limb):
    """The main path's calls (n = 2^14, h = 64) plan two kernels each, S6's
    first launch over 32 CTAs, S5's over its 16 segments; the instances
    switch where the wrappers' docs say: S6's persistent reservoir up to h
    = HWT_PARTIAL_MAX_H, S5's candidates in shared memory while h + 8
    sqrt(h) + 16 of them are expected within HWT_CAND_MAX (not at h = n /
    4)."""
    n, h = 1 << 14, 64
    pl6, pl5 = s6.plan(n, h), s5.plan(n, h)
    assert (pl6.fast, pl6.kernels, pl6.grid) == (True, 2, 32)
    assert (pl5.fast, pl5.kernels, pl5.grid) == (True, 2, 16)
    assert s6.state_bytes == 16 + 4 * _kernels.HWT_PARTIAL_MAX_H
    cap = _kernels.HWT_PARTIAL_MAX_H
    assert s6.plan(n, cap).fast and not s6.plan(n, 2 * cap).fast
    assert s6.plan(n, 2 * cap).kernels == 3
    assert not s5.plan(n, n // 4).fast and s5.plan(n, 1024).fast
    assert s5.plan(1 << 20, h).fast and s5.plan(1 << 20, h).grid == 1024


@pytest.mark.parametrize("limb,n", [("u16", 4), ("u32", 2), ("u64", 1)])
def test_rows_under_16_bytes_store_word_by_word(s5, s6, limb, n):
    """Degrees whose rows are not a multiple of 16 bytes take the store's
    one-word path; S5 and S6 at every h, in both instances, against the
    twins and (S6) the host sampler and its advance."""
    ring = _ring(limb, n)
    p = _p(ring)
    for h in range(1, n + 1):
        mode = tsamp.hwt_dist(h)
        st = Salsa20Stream(KEY, 3)
        host = tsamp.sample_hwt(ring, st, mode)
        want5 = tdev.device_hwt_plain(ring, KEY, 3, mode, "cpu")
        want6, wadv = tdev.device_hwt_exact_plain(ring, KEY, 3, mode, True,
                                                  device="cpu")
        for cap in CAPS:
            assert torch.equal(s5(KEY, 3, p, n, h, ring.torch_dtype,
                                  cap=cap), want5)
            got, adv = s6(KEY, 3, p, n, h, ring.torch_dtype, cap=cap)
            assert torch.equal(got, want6) and int(adv) == int(wadv)
        np.testing.assert_array_equal(_u(want6, ring), host)
        assert int(wadv) == st.nonce - 3


def test_s6_chains_from_its_tensor_advance(s6):
    """Two exact draws, the second at nonce + the first's advance (a
    tensor), equal two draws of one host stream."""
    ring = _ring("u32")
    mode = tsamp.hwt_dist(32)
    st = Salsa20Stream(KEY, 2)
    want1 = tsamp.sample_hwt(ring, st, mode)
    want2 = tsamp.sample_hwt(ring, st, mode)
    got1, adv1 = s6(KEY, 2, _p(ring), 256, 32, ring.torch_dtype)
    got2, adv2 = s6(KEY, 2 + adv1, _p(ring), 256, 32, ring.torch_dtype)
    np.testing.assert_array_equal(_u(got1, ring), want1)
    np.testing.assert_array_equal(_u(got2, ring), want2)
    assert int(adv1) + int(adv2) == st.nonce - 2


def _host_walk(words, n, h):
    """the host walk's reservoir on given words: (rejected words, words
    consumed)"""
    it = iter(int(w) for w in words)
    rejected = consumed = 0
    for k in range(h, n):
        while True:
            consumed += 1
            if int(next(it)) <= M - M % k:
                break
            rejected += 1
    return rejected, consumed


@pytest.mark.parametrize("cap", CAPS)
def test_s6_words_in_resolves_ambiguous_words(s6, cap):
    """The words-in instance with ambiguous words planted in the
    reservoir's stream, in both halves of a stream that the many-block
    instance splits over two blocks' records: 2^64 - 1 (rejected unless k
    divides it) and 2^64 - n (accepted at every k); equal to the twin's
    core on the same words, the advance the host walk's."""
    ring = _ring("u32", 4096)
    n, h = 4096, 64
    wtot = tdev._hwt_fills(n, h) * h
    rng = np.random.default_rng(17)
    words = rng.integers(0, 1 << 63, size=wtot, dtype=np.uint64) * 2 \
        + rng.integers(0, 2, size=wtot, dtype=np.uint64)
    words[[3, 900, 2500, 3900]] = M
    words[[40, 3100]] = M - n + 1
    rejected, consumed = _host_walk(words, n, h)
    assert rejected >= 3
    for v in NONCES:
        nonce, _ = _nonce(v)
        W = _words(words)
        want, wadv = tdev.hwt_exact_from_words(ring, KEY, nonce, W, h, 8,
                                               "cpu")
        got, adv = s6(KEY, nonce, _p(ring), n, h, ring.torch_dtype, 8,
                      words=W, cap=cap)
        _expect_kernels(s6, n, h, True, cap)
        assert torch.equal(got, want)
        assert int(adv) == int(wadv) == -(-consumed // h) + 1


@pytest.mark.parametrize("cap", CAPS)
def test_s6_words_in_accepted_ambiguous_words_merge(s6, cap):
    """Ambiguous words that every k accepts (2^64 - n), spread over several
    CTAs' records, and no rejection: the last CTA resolves them and folds
    the partials (the merge branch), equal to the twin's core and the
    host walk's advance."""
    ring = _ring("u32", 4096)
    n, h = 4096, 64
    wtot = tdev._hwt_fills(n, h) * h
    rng = np.random.default_rng(23)
    words = rng.integers(0, 1 << 63, size=wtot, dtype=np.uint64) * 2
    words[[5, 700, 1900, 2600, 4000, 4090]] = M - n + 1
    rejected, consumed = _host_walk(words, n, h)
    assert rejected == 0
    W = _words(words)
    want, wadv = tdev.hwt_exact_from_words(ring, KEY, 4, W, h, 8, "cpu")
    got, adv = s6(KEY, 4, _p(ring), n, h, ring.torch_dtype, 8, words=W,
                  cap=cap)
    _expect_kernels(s6, n, h, True, cap)
    assert torch.equal(got, want)
    assert int(adv) == int(wadv) == -(-consumed // h) + 1


@pytest.mark.parametrize("cap", CAPS)
def test_s6_words_in_budget_guard(s6, cap):
    """The guard poisons every residue with all-ones words and gives the
    advance -1: with more ambiguous words than amb_cap, and with too few
    accepted words for the reservoir (all words 2^64 - 1); equal to the
    twin.  At amb_cap 0 the keystream's own call equals the twin's."""
    ring = _ring("u32", 32)
    n, h = 32, 8
    wtot = tdev._hwt_fills(n, h) * h
    rng = np.random.default_rng(5)
    many = rng.integers(0, 1 << 62, size=wtot, dtype=np.uint64)
    many[:5] = M - 1
    for words, amb_cap in ((many, 3), (np.full(wtot, M, np.uint64), 64)):
        W = _words(words)
        want, wadv = tdev.hwt_exact_from_words(ring, KEY, 9, W, h, amb_cap,
                                               "cpu")
        got, adv = s6(KEY, 9, _p(ring), n, h, ring.torch_dtype, amb_cap,
                      words=W, cap=cap)
        assert int(adv) == int(wadv) == -1
        assert torch.equal(got, want) and bool((got == -1).all())
    got, adv = s6(KEY, 9, _p(ring), n, h, ring.torch_dtype, 0, cap=cap)
    want, wadv = tdev.device_hwt_exact_plain(ring, KEY, 9,
                                             tsamp.hwt_dist(h), True, 0,
                                             "cpu")
    assert torch.equal(got, want) and int(adv) == int(wadv)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("keys", ["ties", "equal", "top_byte", "signed"])
def test_s5_words_in_order_under_ties(s5, keys, cap):
    """The words-in instance's keys with ties (a stable order: the lower
    index first), all keys equal, keys that share their top bytes (the
    passes on the low bytes and the index), and keys with the top bit set
    (unsigned order); equal to the twin's core on the same keys, with the
    keystream's sign words."""
    ring = _ring("u64", 256)
    n, h = 256, 37
    rng = np.random.default_rng(3)
    vals = {"ties": rng.choice(np.array([0, 7, 1 << 40, M], np.uint64), n),
            "equal": np.full(n, 12345, np.uint64),
            "top_byte": (np.uint64(0xAB) << np.uint64(56))
            | rng.integers(0, 64, size=n, dtype=np.uint64),
            "signed": rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
            * 2 + rng.integers(0, 2, size=n, dtype=np.uint64)}[keys]
    K = _words(vals)
    for v in NONCES:
        nonce, _ = _nonce(v)
        signs = tdev._stream_limbs(KEY, nonce, n + h, 8, "cpu")[n:]
        want = tdev.hwt_fixed_from_keys(ring, K, signs, "cpu")
        got = s5(KEY, nonce, _p(ring), n, h, ring.torch_dtype, words=K,
                 cap=cap)
        _expect_kernels(s5, n, h, True, cap)
        assert torch.equal(got, want)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("h,keys", [(300, "four"), (1500, "four"),
                                    (100, "few_small")])
def test_s5_words_in_ties_across_segments(s5, h, keys, cap):
    """Tie groups that span the four segments at n = 4096.  "four": keys
    from four values, most below the threshold, so the CTAs' slots
    overflow and the last CTA selects among all keys (the h-th smallest
    pair in segment 1 at h = 300, h above a segment's 1024 keys at 1500).
    "few_small": 200 keys from three small values spread over the
    segments, the rest above 2^63, so the candidates are those 200 and
    the last CTA selects among them (with a cap of 0 among all keys).
    Equal to the twin's core on the same keys (a stable argsort)."""
    ring = _ring("u32", 4096)
    n = ring.degree
    rng = np.random.default_rng(31)
    if keys == "four":
        vals = rng.choice(np.array([0, 7, 1 << 40, M], np.uint64), n)
    else:
        vals = rng.integers(1 << 63, M, size=n, dtype=np.uint64,
                            endpoint=True)
        vals[rng.choice(n, 200, replace=False)] = rng.choice(
            np.array([5, 9, 13], np.uint64), 200)
    K = _words(vals)
    signs = tdev._stream_limbs(KEY, 6, n + h, 8, "cpu")[n:]
    want = tdev.hwt_fixed_from_keys(ring, K, signs, "cpu")
    got = s5(KEY, 6, _p(ring), n, h, ring.torch_dtype, words=K, cap=cap)
    _expect_kernels(s5, n, h, True, cap)
    assert torch.equal(got, want)


def test_s5_unplanned_selection_makes_the_keys_again(s5):
    """With a cap of exactly the expected candidates (h + 8 sqrt(h) + 16)
    the plan selects among them and the first launch keeps no keys; at a
    nonce
    whose keystream puts more keys below the threshold than the cap, the
    last CTA makes the keys again and selects among all of them.  Both
    nonces equal the twin."""
    ring = _ring("u32", 256)
    n, h = 256, 4
    expect = h + 8 * h ** 0.5 + 16
    cap = int(expect)
    thr = int(expect / n * 2.0 ** 64)
    seen = set()
    for nonce in range(64):
        keys = tdev._stream_limbs(KEY, nonce, n, 8, "cpu").numpy() \
            .view(np.uint64)
        over = int((keys <= np.uint64(thr)).sum()) > cap
        if over in seen:
            continue
        seen.add(over)
        got = s5(KEY, nonce, _p(ring), n, h, ring.torch_dtype, cap=cap)
        assert s5.plan(n, h, False, cap).fast
        assert torch.equal(got, tdev.device_hwt_plain(
            ring, KEY, nonce, tsamp.hwt_dist(h), "cpu"))
    assert seen == {False, True}


def test_dispatch_runs_twins_on_the_cpu():
    """On CPU tensors device_hwt and device_hwt_exact run their twins and
    launch nothing; the wrappers refuse tensors off the card, and an
    amb_cap past the kernel's."""
    ring = _ring("u32")
    mode = tsamp.hwt_dist(16)
    before = (_kernels.HWT_FIXED.launches, _kernels.HWT_EXACT.launches)
    assert torch.equal(tdev.device_hwt(ring, KEY, 3, mode, "cpu"),
                       tdev.device_hwt_plain(ring, KEY, 3, mode, "cpu"))
    got, adv = tdev.device_hwt_exact(ring, KEY, 3, mode, True, device="cpu")
    want, wadv = tdev.device_hwt_exact_plain(ring, KEY, 3, mode, True,
                                             device="cpu")
    assert torch.equal(got, want) and int(adv) == int(wadv)
    assert (_kernels.HWT_FIXED.launches,
            _kernels.HWT_EXACT.launches) == before
    p = _p(ring)
    with pytest.raises(ValueError, match="on the card"):
        _kernels.HWT_FIXED(KEY, 3, p, 256, 16, torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        _kernels.HWT_EXACT(KEY, 3, p, 256, 16, torch.int32)
    with pytest.raises(ValueError, match="amb_cap"):
        _kernels.HWT_EXACT(KEY, 3, p, 256, 16, torch.int32, 65)
