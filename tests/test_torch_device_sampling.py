"""The port's device-tier samplers (prng/device_sampling.py,
prng/salsa20.py:device_stream_words, Poly.sample_on_device) against the JAX
package's device tier and the port's host tier, case by case as
tests/test_device_sampling.py and tests/test_ondevice_roundtrip.py hold the
JAX package: exact equality (tolerance 0).  The port's tensors live on the
CPU (DEV), where the keystream kernel S1 and the Gaussian's kernels S3
and S4 run as their plain twins; tests/test_torch_sampling_host.py and
tests/test_torch_gaussian_kernels.py run the kernels' own code against
the same twins."""
import functools

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.prng import device_sampling as jdev
from nfllib_tpu.prng import sampling as jsamp
from nfllib_tpu.prng.gaussian import FastGaussianNoise as JFastGaussianNoise
from nfllib_tpu.prng.salsa20 import device_stream_words as jstream_words
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import device_sampling as dev
from nfllib_tpu_torch.prng import device_stream_words, sampling
from nfllib_tpu_torch.prng.gaussian import FastGaussianNoise
from nfllib_tpu_torch.prng.salsa20 import Salsa20Stream
from nfllib_tpu_torch.serialize import deserialize_poly, serialize_poly

from conftest import make_ring as make_jring

DEV = "cpu"
KEY = b"\x5A" * 32

CONFIGS = [
    (128, 14, "u16"),
    (256, 60, "u32"),
    (64, 124, "u64"),
]


def make_ring(degree, agg, limb):
    return tnfl.ring_from_modulus(limb, degree, agg)


def _u(t, ring):
    """storage tensor -> unsigned residues (the JAX package's layout)"""
    return t.numpy().view(ring.dtype)


def _jmode(mode, jfg=None):
    """the JAX package's sampler mode of the same parameters"""
    if isinstance(mode, sampling.gaussian):
        return jsamp.gaussian(jfg, mode.amplifier)
    return getattr(jsamp, type(mode).__name__)(
        *(getattr(mode, f) for f in mode.__dataclass_fields__))


# ---------------------------------------------------------------------------
# the keystream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonce,nblocks", [(0, 1), (3, 5), (1 << 40, 33),
                                           ((1 << 64) - 1, 2)])
def test_device_stream_words_matches_jax_and_host(nonce, nblocks):
    """int and 0-d tensor nonces (the traced nonce of the JAX package),
    byte-equal to the host stream and word-equal to the JAX device words,
    up to the nonce 2^64 - 1."""
    want = np.asarray(jstream_words(KEY, nonce, nblocks))
    host = Salsa20Stream(KEY, nonce).randombytes(64 * nblocks)
    signed = nonce - (1 << 64) if nonce >> 63 else nonce
    for n in (nonce, torch.tensor(signed, dtype=torch.int64)):
        got = device_stream_words(KEY, n, nblocks, DEV)
        assert got.shape == (nblocks, 16) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        assert got.numpy().tobytes() == host


def test_device_stream_words_golden_and_wrap():
    """The reference's qhasm keystream's first 1 KB, and fills across the
    nonce wrap: nonce 2^64 - 1 + f reads the streams at 2^64 - 1, 0, 1."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tools", "golden", "salsa20_golden.bin"),
              "rb") as f:
        golden = f.read()
    got = device_stream_words(bytes(range(32)), 0, 16, DEV)
    assert got.numpy().tobytes() == golden[:1024]
    from nfllib_tpu_torch.prng.salsa20 import keystream, nonce_add
    rows = keystream(KEY, (1 << 64) - 1, 3, 3, DEV)
    for f, n in enumerate(((1 << 64) - 1, 0, 1)):
        assert rows[f].numpy().tobytes() == \
            Salsa20Stream(KEY, n).randombytes(192)
    t = nonce_add(torch.tensor(-1, dtype=torch.int64), 2)
    assert int(t) == 1 and nonce_add((1 << 64) - 1, 3) == 2
    assert int(nonce_add((1 << 64) - 1, torch.tensor(1))) == 0


# ---------------------------------------------------------------------------
# uniform, non_uniform, ZO: bit-identical to JAX's device tier and the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_uniform_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    want = sampling.sample_uniform(ring, Salsa20Stream(KEY, nonce=3))
    got = dev.device_uniform(ring, KEY, 3, DEV)
    assert got.dtype == ring.torch_dtype
    np.testing.assert_array_equal(_u(got, ring), want)
    jring = make_jring(degree, agg, limb)
    np.testing.assert_array_equal(_u(got, ring),
                                  np.asarray(jdev.device_uniform(jring, KEY,
                                                                 3)))


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_non_uniform_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    mode = sampling.non_uniform(7, 2)
    want = sampling.sample_non_uniform(ring, Salsa20Stream(KEY), mode)
    got = dev.device_non_uniform(ring, KEY, 0, mode, DEV)
    np.testing.assert_array_equal(_u(got, ring), want)
    jring = make_jring(degree, agg, limb)
    np.testing.assert_array_equal(
        _u(got, ring), np.asarray(jdev.device_non_uniform(
            jring, KEY, 0, jsamp.non_uniform(7, 2))))
    with pytest.raises(ValueError):
        dev.device_non_uniform(ring, KEY, 0, sampling.non_uniform(1 << 62),
                               DEV)


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
def test_device_zo_matches_host(degree, agg, limb):
    ring = make_ring(degree, agg, limb)
    mode = sampling.ZO_dist(0x7F)
    want = sampling.sample_zo(ring, Salsa20Stream(KEY, nonce=9), mode)
    got = dev.device_zo(ring, KEY, 9, mode, DEV)
    np.testing.assert_array_equal(_u(got, ring), want)
    jring = make_jring(degree, agg, limb)
    np.testing.assert_array_equal(
        _u(got, ring), np.asarray(jdev.device_zo(jring, KEY, 9,
                                                 jsamp.ZO_dist(0x7F))))


# ---------------------------------------------------------------------------
# the fixed-consumption Gaussian
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fgs():
    return (FastGaussianNoise(4.0, 128, 1 << 10),
            JFastGaussianNoise(4.0, 128, 1 << 10))


def _gaussian_case(ring, jring, fg, jfg, nonce, amp=1):
    """the port's device_gaussian, checked against the JAX package's and
    against the host mirror get_noise_fixed on the same keystream"""
    got = dev.device_gaussian(ring, KEY, nonce, sampling.gaussian(fg, amp),
                              DEV)
    np.testing.assert_array_equal(
        _u(got, ring), np.asarray(jdev.device_gaussian(
            jring, KEY, nonce, jsamp.gaussian(jfg, amp))))
    n, wp = ring.degree, fg.word_precision
    if fg.in_bits == 8:
        raw = np.frombuffer(Salsa20Stream(KEY, nonce).randombytes(n * wp),
                            dtype=np.uint8).reshape(n, wp).astype(np.uint16)
    else:
        raw = np.frombuffer(Salsa20Stream(KEY, nonce).randombytes(
            n * wp * 2), dtype="<u2").reshape(n, wp)
    want_noise = fg.get_noise_fixed(raw) * amp
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        want = np.where(want_noise < 0, p + want_noise, want_noise)
        np.testing.assert_array_equal(_u(got, ring)[cm].astype(np.int64),
                                      want)
    return got


@pytest.mark.parametrize("limb,degree,agg,amp", [
    ("u32", 256, 60, 1), ("u32", 256, 60, 2), ("u16", 256, 28, 2),
    ("u64", 256, 124, 1)])
def test_device_gaussian_matches_fixed_host_mirror(fgs, limb, degree, agg,
                                                   amp):
    fg, jfg = fgs
    _gaussian_case(make_ring(degree, agg, limb),
                   nfl.ring_from_modulus(limb, degree, agg), fg, jfg, 5, amp)


@pytest.mark.parametrize("sigma", [20.0, 80.0])
def test_device_gaussian_large_sigma_matches_mirror(sigma):
    """Wide Gaussians have many more barriers and deeper binary searches
    (incl. tail barriers that differ only in deep words)."""
    _gaussian_case(make_ring(512, 60, "u32"), make_jring(512, 60, "u32"),
                   FastGaussianNoise(sigma, 128, 1 << 10),
                   JFastGaussianNoise(sigma, 128, 1 << 10), 9)


def test_device_gaussian_in_bits_16_matches_mirror():
    """The 16-bit word flavor consumes little-endian 16-bit stream limbs."""
    _gaussian_case(make_ring(256, 60, "u32"), make_jring(256, 60, "u32"),
                   FastGaussianNoise(4.0, 128, 1 << 10, in_bits=16),
                   JFastGaussianNoise(4.0, 128, 1 << 10, in_bits=16), 3)


def test_device_gaussian_moments(fgs):
    fg, _ = fgs
    ring = make_ring(8192, 60, "u32")
    got = dev.device_gaussian(ring, KEY, 11, sampling.gaussian(fg), DEV)
    p0 = int(ring.moduli[0])
    signed = _u(got, ring)[0].astype(np.int64)
    signed = np.where(signed > p0 // 2, signed - p0, signed)
    assert abs(signed.mean()) < 0.3
    assert abs(signed.std() - 4.0) < 0.3
    assert np.all(np.abs(signed) <= 6 * 4 + 1)


def test_device_gaussian_fits_the_barrier_cdf(fgs):
    """Seeded goodness of fit: the counts of 2^16 device samples (32
    nonces of n = 2048) per value against the exact probabilities the
    barriers define (differences of consecutive barriers over 2^prec), a
    chi-square over the values with expectation >= 5, the tails pooled;
    the bound is the 99.9 % point of chi-square at that many degrees of
    freedom (Wilson-Hilferty)."""
    fg, _ = fgs
    ring = make_ring(2048, 30, "u32")
    p0 = int(ring.moduli[0])
    vals = []
    for nonce in range(32):
        v = _u(dev.device_gaussian(ring, KEY, 1000 + nonce,
                                   sampling.gaussian(fg), DEV), ring)[0]
        v = v.astype(np.int64)
        vals.append(np.where(v > p0 // 2, v - p0, v))
    vals = np.concatenate(vals)
    total = 1 << fg.bit_precision
    bars = [0] + list(fg.barriers) + [total]
    probs = np.array([(bars[i + 1] - bars[i]) / total
                      for i in range(len(bars) - 1)], dtype=np.float64)
    support = fg.base_value + np.arange(len(probs))
    counts = np.array([(vals == s).sum() for s in support], dtype=np.float64)
    assert counts.sum() == vals.size
    expect = probs * vals.size
    keep = expect >= 5
    obs = np.append(counts[keep], counts[~keep].sum())
    exp = np.append(expect[keep], expect[~keep].sum())
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    k = len(obs) - 1
    z = 3.09                                   # the 99.9 % normal quantile
    bound = k * (1 - 2 / (9 * k) + z * np.sqrt(2 / (9 * k))) ** 3
    assert chi2 < bound, (chi2, bound, k)


def test_poly_sample_on_device():
    ring = make_ring(256, 60, "u32")
    a = tnfl.Poly.sample_on_device(ring, tnfl.uniform(), KEY, 1, device=DEV)
    b = tnfl.Poly.sample(ring, tnfl.uniform(), Salsa20Stream(KEY, nonce=1),
                         device=DEV)
    assert a == b and a.device.type == "cpu"


# ---------------------------------------------------------------------------
# stream-exact device Gaussian + device hwt
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _samplers(**cfg):
    """(the port's, the JAX package's) FastGaussianNoise of cfg, made once
    (seconds each at in_bits 16)"""
    return FastGaussianNoise(**cfg), JFastGaussianNoise(**cfg)


@pytest.mark.parametrize("cfg", [
    dict(sigma=20.0, security=128, samples=256, in_bits=8, lu_depth=2),
    dict(sigma=3.2, security=80, samples=256, in_bits=8, lu_depth=1),
    dict(sigma=20.0, security=128, samples=256, in_bits=16, lu_depth=2),
])
def test_device_gaussian_exact_matches_host_walk(cfg):
    """device_gaussian_exact is bit-identical to the host walk and to the
    JAX package's device_gaussian_exact for the same (key, nonce), across
    lu depths and both in_bits flavors, and reports the host's fills."""
    fg, jfg = _samplers(**cfg)
    ring, jring = tnfl.Ring("u32", 256, 2), nfl.Ring("u32", 256, 2)
    tables = dev.gaussian_tables(fg, DEV, exact=True)
    for nonce in (0, 5):
        for ampl in (1, 2):
            mode = sampling.gaussian(fg, ampl)
            st = Salsa20Stream(KEY, nonce)
            want = sampling.sample_gaussian(ring, st, mode)
            got, fills = dev.device_gaussian_exact(ring, KEY, nonce, mode,
                                                   True, DEV, tables)
            np.testing.assert_array_equal(_u(got, ring), want)
            assert fills.dim() == 0 and int(fills) == st.nonce - nonce
            jgot, jfills = jdev.device_gaussian_exact(
                jring, KEY, nonce, jsamp.gaussian(jfg, ampl), True)
            np.testing.assert_array_equal(_u(got, ring), np.asarray(jgot))
            assert int(jfills) == int(fills)


def test_device_gaussian_exact_refill_crossing():
    """The exact walk reproduces the host's refill policy (each fill is a
    fresh nonce; leftover words discarded) across multiple refills, and
    chains from a tensor nonce."""
    fg = FastGaussianNoise(sigma=250.0, security=128, samples=2048)
    ring = make_ring(2048, 124, "u64")
    mode = sampling.gaussian(fg, 2)
    st = Salsa20Stream(KEY, nonce=5)
    want = sampling.sample_gaussian(ring, st, mode)
    advance = st.nonce - 5
    want2 = sampling.sample_gaussian(ring, st, mode)
    got, fills = dev.device_gaussian_exact(ring, KEY, 5, mode, True, DEV)
    np.testing.assert_array_equal(_u(got, ring), want)
    assert int(fills) == advance == 2        # the host refilled once
    got2 = dev.device_gaussian_exact(ring, KEY, 5 + fills, mode, device=DEV)
    np.testing.assert_array_equal(_u(got2, ring), want2)


# Below its fill size (innoise < word_precision) the JAX package reads a
# sample's words at negative positions by its gathers' rule (normalised
# once, else INT32_MIN, or clamped where it indexes F2 / V2) while the host
# walk reads past its fill: the two agree only at the cases of
# EXACT_SMALL_HOST.  The port is held to the JAX package everywhere.
EXACT_SMALL_KEY = b"\x0b" * 32
EXACT_SMALL_SAMPLERS = {
    "demo": None,                 # apps/lwe.py:make_gaussian_prng(256)
    "sigma20": dict(sigma=20.0, security=128, samples=256, in_bits=8,
                    lu_depth=2),
    "sigma3.2": dict(sigma=3.2, security=80, samples=256, in_bits=8,
                     lu_depth=1),
    "sigma20_in16": dict(sigma=20.0, security=128, samples=256, in_bits=16,
                         lu_depth=2),
}
EXACT_SMALL_BITS = {"u16": 28, "u32": 60, "u64": 124}
EXACT_SMALL_CASES = (
    [("demo", limb, n) for limb in ("u16", "u32", "u64")
     for n in (2, 4, 8, 16)]
    + [(s, "u32", n) for s in ("sigma20", "sigma3.2", "sigma20_in16")
       for n in (2, 4, 8)])
EXACT_SMALL_HOST = ({("demo", limb, n) for limb in ("u16", "u32", "u64")
                     for n in (8, 16)} | {("sigma3.2", "u32", 8)})


def _exact_small_samplers(sampler):
    """(the port's, the JAX package's) FastGaussianNoise of a sampler of
    EXACT_SMALL_SAMPLERS"""
    cfg = EXACT_SMALL_SAMPLERS[sampler]
    if cfg is None:
        from nfllib_tpu.apps import lwe as jlwe
        from nfllib_tpu_torch.apps import lwe as tlwe
        return (tlwe.make_gaussian_prng(samples=256),
                jlwe.make_gaussian_prng(samples=256))
    return _samplers(**cfg)


@pytest.mark.parametrize("sampler,limb,n", EXACT_SMALL_CASES)
def test_device_gaussian_exact_below_fill_size_matches_jax(sampler, limb, n):
    """At n = 2 .. 16 a fill holds innoise <= word_precision words (2 to
    29): the port's device_gaussian_exact equals the JAX package's bit for
    bit, residues and fill count, at amps 1 and 2, and equals the host
    walk and its advance exactly where the JAX draw does
    (EXACT_SMALL_HOST)."""
    fg, jfg = _exact_small_samplers(sampler)
    bits = EXACT_SMALL_BITS[limb]
    ring = tnfl.ring_from_modulus(limb, n, bits)
    jring = nfl.ring_from_modulus(limb, n, bits)
    assert int(np.float32(n) * np.float32(fg.innoise_multiplier)) \
        <= 2 * fg.word_precision
    for amp in (1, 2):
        got, fills = dev.device_gaussian_exact(
            ring, EXACT_SMALL_KEY, 7, sampling.gaussian(fg, amp), True, DEV)
        jgot, jfills = jdev.device_gaussian_exact(
            jring, EXACT_SMALL_KEY, 7, jsamp.gaussian(jfg, amp), True)
        np.testing.assert_array_equal(_u(got, ring), np.asarray(jgot))
        assert int(fills) == int(jfills)
        st = Salsa20Stream(EXACT_SMALL_KEY, 7)
        host = sampling.sample_gaussian(ring, st, sampling.gaussian(fg, amp))
        on_host = (np.array_equal(np.asarray(jgot), host)
                   and int(jfills) == st.nonce - 7)
        assert on_host == ((sampler, limb, n) in EXACT_SMALL_HOST)
        if on_host:
            np.testing.assert_array_equal(_u(got, ring), host)
            assert int(fills) == st.nonce - 7


@pytest.mark.parametrize("limb,n", [("u32", 16), ("u64", 8)])
def test_encrypt_on_device_exact_below_fill_size_is_host_encrypt(limb, n):
    """The exact encryption's three chained samplers at a degree whose
    fills hold 9 or 18 words: keys from the JAX package's keygen carried
    across, the port's encrypt_on_device(exact=True) equals its host
    encrypt() from a stream at the same (key, nonce)."""
    from nfllib_tpu.apps import lwe as jlwe
    from nfllib_tpu.prng.salsa20 import Salsa20Stream as JStream
    from nfllib_tpu_torch import interop
    from nfllib_tpu_torch.apps import lwe as tlwe
    bits = EXACT_SMALL_BITS[limb]
    jstream = JStream(EXACT_SMALL_KEY)
    jkeys = jlwe.keygen(nfl.ring_from_modulus(limb, n, bits), jstream,
                        jlwe.make_gaussian_prng(samples=256))
    ring = tnfl.ring_from_modulus(limb, n, bits)
    keys = interop.lwe_keys_from_numpy(
        *(np.asarray(getattr(jkeys, k).data)
          for k in ("s", "sprime", "pka", "pkb")), ring, device=DEV)
    g = tlwe.make_gaussian_prng(samples=256)
    da, db = tlwe.encrypt_on_device(keys, ring, EXACT_SMALL_KEY,
                                    jstream.nonce, g, exact=True)
    ha, hb = tlwe.encrypt(keys, ring,
                          Salsa20Stream(EXACT_SMALL_KEY, jstream.nonce), g)
    assert ha == da and hb == db


def test_device_hwt_structure():
    """device_hwt: exactly h hits, reference encoding (+1 as the
    non-canonical p+1, -1 as p-1), consistent positions and signs across
    channels, nonce-sensitive, equal to the JAX package's."""
    ring = tnfl.Ring("u32", 512, 2)
    h = 64
    got = _u(dev.device_hwt(ring, KEY, 0, sampling.hwt_dist(h), DEV), ring)
    for cm in range(2):
        p = int(ring.moduli[cm])
        nz = got[cm][got[cm] != 0]
        assert len(nz) == h
        assert set(int(v) for v in nz) <= {p - 1, p + 1}
    pos0 = np.nonzero(got[0])[0]
    pos1 = np.nonzero(got[1])[0]
    np.testing.assert_array_equal(pos0, pos1)
    p0, p1 = int(ring.moduli[0]), int(ring.moduli[1])
    np.testing.assert_array_equal(got[0][pos0] == p0 + 1,
                                  got[1][pos1] == p1 + 1)
    got2 = _u(dev.device_hwt(ring, KEY, 1, sampling.hwt_dist(h), DEV), ring)
    assert not np.array_equal(got, got2)
    got3 = _u(dev.device_sample(ring, sampling.hwt_dist(h), KEY, 0, DEV),
              ring)
    np.testing.assert_array_equal(got3, got)
    want = np.asarray(jdev.device_hwt(nfl.Ring("u32", 512, 2), KEY, 0,
                                      jsamp.hwt_dist(h)))
    np.testing.assert_array_equal(got, want)


def test_device_hwt_subset_uniformity():
    """Coarse acceptance: across many nonces every position is hit with
    frequency ~ h/n."""
    ring = tnfl.Ring("u32", 64, 1)
    h = 8
    trials = 200
    counts = np.zeros(64)
    for nonce in range(trials):
        got = dev.device_hwt(ring, KEY, nonce, sampling.hwt_dist(h), DEV)
        counts += got[0].numpy() != 0
    expected = trials * h / 64
    sd = np.sqrt(trials * (h / 64) * (1 - h / 64))
    assert np.all(np.abs(counts - expected) < 6 * sd), counts


@pytest.mark.parametrize("degree,agg,limb", CONFIGS)
@pytest.mark.parametrize("hfrac", ["one", "quarter", "full"])
def test_device_hwt_exact_matches_host(degree, agg, limb, hfrac):
    """Same (key, nonce) => byte-identical output to the host reservoir
    and to the JAX package's device_hwt_exact."""
    ring = make_ring(degree, agg, limb)
    h = {"one": 1, "quarter": degree // 4, "full": degree}[hfrac]
    mode = sampling.hwt_dist(h)
    for nonce in (0, 5):
        want = sampling.sample_hwt(ring, Salsa20Stream(KEY, nonce=nonce),
                                   mode)
        got = dev.device_hwt_exact(ring, KEY, nonce, mode, device=DEV)
        np.testing.assert_array_equal(_u(got, ring), want)
    jgot = jdev.device_hwt_exact(make_jring(degree, agg, limb), KEY, 5,
                                 jsamp.hwt_dist(h))
    np.testing.assert_array_equal(_u(got, ring), np.asarray(jgot))


def test_device_hwt_exact_chains_like_host():
    """return_fills (a device tensor) lets consecutive exact draws mirror
    one host stream, the second draw's nonce never read on the host."""
    ring = make_ring(256, 60, "u32")
    mode = sampling.hwt_dist(32)
    st = Salsa20Stream(KEY, nonce=2)
    want1 = sampling.sample_hwt(ring, st, mode)
    want2 = sampling.sample_hwt(ring, st, mode)
    got1, adv1 = dev.device_hwt_exact(ring, KEY, 2, mode, return_fills=True,
                                      device=DEV)
    got2 = dev.device_hwt_exact(ring, KEY, 2 + adv1, mode, device=DEV)
    np.testing.assert_array_equal(_u(got1, ring), want1)
    np.testing.assert_array_equal(_u(got2, ring), want2)
    assert int(adv1) == (st.nonce - 2) // 2


def _host_walk_on_words(words, n, h):
    """Python mirror of sampling.sample_hwt's reservoir on a given word
    stream (fills of h words are just consecutive h-slices here)."""
    M = (1 << 64) - 1
    hitted = list(range(h))
    consumed = 0
    it = iter(words)
    for k in range(h, n):
        while True:
            w = int(next(it))
            consumed += 1
            if w <= (M // k) * k:
                pos = w % k
                break
        if pos < h:
            hitted[pos] = k
    hitted.sort()
    return hitted, -(-consumed // h)


def _signed(words):
    return torch.from_numpy(np.asarray(words, dtype=np.uint64)
                            .view(np.int64).copy())


def test_hwt_word_core_resolves_rejections():
    """_hwt_positions_from_words handles the data-dependent rejection path
    exactly: synthetic streams salted with near-2^64 words reproduce the
    host walk's reservoir AND its fill count, as the JAX package's core
    does."""
    import jax.numpy as jnp
    rng = np.random.default_rng(42)
    n, h = 96, 16
    M = (1 << 64) - 1
    for trial in range(20):
        budget = n
        words = rng.integers(0, 1 << 63, size=budget, dtype=np.uint64) * 2 \
            + rng.integers(0, 2, size=budget, dtype=np.uint64)
        namb = int(rng.integers(0, 7))
        slots = rng.choice(n - h, size=namb, replace=False)
        words[slots] = M - rng.integers(0, n, size=namb, dtype=np.uint64)
        want_hitted, want_fills = _host_walk_on_words(words, n, h)
        order, fills, ok = dev._hwt_positions_from_words(
            _signed(words), n, h, amb_cap=budget)
        np.testing.assert_array_equal(order.numpy(), want_hitted)
        assert int(fills) == want_fills, trial
        assert bool(ok), trial
        if trial < 4:
            jorder, jfills, jok = jdev._hwt_positions_from_words(
                jnp.asarray(words), n, h, amb_cap=budget)
            np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
            assert int(jfills) == int(fills) and bool(jok)


def test_hwt_word_core_budget_guard():
    """The ok flag trips when either exactness assumption breaks (more
    ambiguous words than amb_cap, or fewer accepted words than the
    reservoir needs), and device_hwt_exact then poisons every residue."""
    rng = np.random.default_rng(7)
    n, h = 96, 16
    M = np.uint64((1 << 64) - 1)
    words = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
    words[:5] = M - np.uint64(1)
    _, _, ok = dev._hwt_positions_from_words(_signed(words), n, h, amb_cap=3)
    assert not bool(ok)
    words_all_rej = np.full(n, M, dtype=np.uint64)
    _, _, ok2 = dev._hwt_positions_from_words(_signed(words_all_rej), n, h,
                                              amb_cap=n)
    assert not bool(ok2)
    ring = make_ring(256, 60, "u32")
    mode = sampling.hwt_dist(32)
    good, adv = dev.device_hwt_exact(ring, KEY, 0, mode, True, 8, DEV)
    assert int(adv) > 0 and bool((_u(good, ring) != 0xFFFFFFFF).all())
    bad, adv = dev.device_hwt_exact(ring, KEY, 0, mode, True, 0, DEV)
    if int(adv) == -1:       # an ambiguous word in the budget: poisoned
        assert bool((_u(bad, ring) == 0xFFFFFFFF).all())
    else:
        np.testing.assert_array_equal(_u(bad, ring), _u(good, ring))


# ---------------------------------------------------------------------------
# on-device sampling, serialization round trip (test_ondevice_roundtrip.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("limb,degree,agg", [("u32", 512, 90),
                                             ("u64", 256, 124)])
def test_ondevice_sample_serialize_roundtrip(limb, degree, agg):
    ring = make_ring(degree, agg, limb)
    jring = nfl.ring_from_modulus(limb, degree, agg)
    key = b"\x61" * 32
    for nonce, mode in [(1, tnfl.uniform()), (2, tnfl.non_uniform(9, 2)),
                        (3, tnfl.ZO_dist())]:
        p = tnfl.Poly.sample_on_device(ring, mode, key, nonce, device=DEV)
        buf = serialize_poly(p)
        assert len(buf) == ring.nmoduli * ring.degree * (4 if limb == "u32"
                                                          else 8)
        q = deserialize_poly(ring, buf, device=DEV)
        assert p == q
        h = tnfl.Poly.sample(ring, mode, Salsa20Stream(key, nonce=nonce),
                             device=DEV)
        assert q == h
        jp = nfl.Poly.sample_on_device(jring, _jmode(mode), key, nonce)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp.data))


def test_device_sample_dispatch(fgs):
    fg, _ = fgs
    ring = make_ring(128, 60, "u32")
    for mode, fn in ((tnfl.uniform(), dev.device_uniform),
                     (tnfl.gaussian(fg), dev.device_gaussian)):
        got = dev.device_sample(ring, mode, KEY, 4, DEV)
        args = (mode,) if isinstance(mode, tnfl.gaussian) else ()
        assert torch.equal(got, fn(ring, KEY, 4, *args, device=DEV))
    with pytest.raises(TypeError):
        dev.device_sample(ring, object(), KEY, 0, DEV)


def test_kernel_wrappers_refuse_cpu_tensors():
    """S1's (raw and sampler instances), S3's and S4's wrappers take only
    CUDA tensors and launch or raise; the samplers send CPU tensors to the
    twins instead, so nothing here counts a launch."""
    from nfllib_tpu_torch import _kernels
    before = [k.launches for k in _kernels.KERNELS]
    fg = FastGaussianNoise(sigma=4.0, security=128, samples=256)
    tabs = dev.gaussian_tables(fg, DEV, exact=True)
    p = torch.ones(2, dtype=torch.int64)
    wp = fg.word_precision
    ring = make_ring(64, 60, "u32")
    p_col = ring.context().to(DEV).p_col
    for call in (lambda: _kernels.SALSA20(KEY, 0, 1, 1, "cpu"),
                 lambda: _kernels.SALSA20_UNIFORM(KEY, 0, p_col, 64,
                                                  torch.int32, 3),
                 lambda: _kernels.SALSA20_NON_UNIFORM(KEY, 0, p_col, 64,
                                                      torch.int32, 7, 5, 3,
                                                      1),
                 lambda: _kernels.SALSA20_ZO(KEY, 0, p_col, 64, torch.int32,
                                             127),
                 lambda: _kernels.GAUSSIAN_FIXED(
                     KEY, 0, [0, 1], [1, 2], 8, 8, wp, tabs.bw, -3, p,
                     torch.int32),
                 lambda: _kernels.GAUSSIAN_EXACT(
                     KEY, 0, 8, 40, 2, 8, wp, 2, tabs, -3, 1, p,
                     torch.int32)):
        with pytest.raises(ValueError):
            call()
    assert [k.launches for k in _kernels.KERNELS] == before
    assert {"salsa20", "salsa20_uniform", "salsa20_non_uniform",
            "salsa20_zo", "gaussian_fixed", "gaussian_exact"} <= {
        k.name for k in _kernels.KERNELS}
    assert "barrier_count" not in {k.name for k in _kernels.KERNELS}
