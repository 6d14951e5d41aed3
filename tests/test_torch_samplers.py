"""The port's host samplers (prng/sampling.py) and FastGaussianNoise
(prng/gaussian.py, prng/mpfr_barriers.py) against nfllib_tpu's: the same
Salsa20 key and nonce give byte-identical residues and leave the stream at
the same nonce; the Gaussian barriers, lookup tables and walks are equal."""
import numpy as np
import pytest

import nfllib_tpu as nfl
from nfllib_tpu.prng import gaussian as jgauss
from nfllib_tpu.prng import mpfr_barriers as jmpfr
from nfllib_tpu.prng.salsa20 import Salsa20Stream as JStream
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.prng import gaussian as tgauss
from nfllib_tpu_torch.prng import mpfr_barriers as tmpfr
from nfllib_tpu_torch.prng import sampling
from nfllib_tpu_torch.prng import Salsa20Stream

DEV = "cpu"
RINGS = [("u16", 128, 28), ("u32", 256, 60), ("u64", 256, 124)]
KEY = bytes(range(7, 39))


def _modes(lib, fg):
    return [lib.uniform(), lib.non_uniform(4), lib.non_uniform(10, 2),
            lib.ZO_dist(0x7F), lib.ZO_dist(0x20), lib.hwt_dist(1),
            lib.hwt_dist(37), lib.gaussian(fg), lib.gaussian(fg, 2)]


@pytest.fixture(scope="module")
def gaussians():
    return (jgauss.FastGaussianNoise(4, 128, 1 << 10),
            tgauss.FastGaussianNoise(4, 128, 1 << 10))


@pytest.mark.parametrize("limb,degree,agg", RINGS)
def test_samplers_match_jax(limb, degree, agg, gaussians):
    """Every sampler, one after another on one stream, through Poly.sample
    in both packages."""
    jring = nfl.ring_from_modulus(limb, degree, agg)
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    js, ts = JStream(KEY, nonce=5), Salsa20Stream(KEY, nonce=5)
    jg, tg = gaussians
    for jmode, tmode in zip(_modes(nfl, jg), _modes(tnfl, tg)):
        want = np.asarray(nfl.Poly.sample(jring, jmode, js).data)
        got = tnfl.Poly.sample(ring, tmode, ts, DEV)
        assert got.data.dtype == ring.torch_dtype
        assert got.numpy().tobytes() == want.tobytes(), tmode
        assert ts.nonce == js.nonce, tmode


def test_sampler_quirks():
    """ZO stores the non-canonical p + 1; hwt sets exactly h coefficients;
    non_uniform wraps negatives to p + v; bad arguments raise."""
    ring = tnfl.ring_from_modulus("u32", 256, 60)
    p = [int(v) for v in ring.moduli]
    zo = sampling.sample(ring, sampling.ZO_dist(0xFF),
                         Salsa20Stream(KEY)).astype(np.int64)
    for cm in range(2):
        assert set(np.unique(zo[cm])) <= {0, p[cm] - 1, p[cm] + 1}
        assert (zo[cm] == p[cm] + 1).any()
    hw = sampling.sample(ring, sampling.hwt_dist(17), Salsa20Stream(KEY))
    assert ((hw != 0).sum(axis=1) == 17).all()
    nu = sampling.sample(ring, sampling.non_uniform(4),
                         Salsa20Stream(KEY)).astype(np.int64)
    for cm in range(2):
        assert ((nu[cm] < 4) | (nu[cm] > p[cm] - 4)).all()
    with pytest.raises(ValueError):
        sampling.sample(ring, sampling.hwt_dist(0), Salsa20Stream(KEY))
    with pytest.raises(ValueError):
        sampling.sample(ring, sampling.non_uniform(p[0]), Salsa20Stream(KEY))
    with pytest.raises(TypeError):
        sampling.sample(ring, object(), Salsa20Stream(KEY))


@pytest.mark.parametrize("sigma,security,samples", [(4, 128, 1 << 10),
                                                    (20, 128, 1 << 14),
                                                    (3.2, 80, 1 << 12)])
def test_fast_gaussian_noise_matches_jax(sigma, security, samples):
    """Barriers (MPFR when libmpfr loads, else mpmath), lookup tables,
    buffer sizing, the stream-exact walk and the fixed-consumption walk."""
    assert tmpfr.available() == jmpfr.available()
    j = jgauss.FastGaussianNoise(sigma, security, samples)
    t = tgauss.FastGaussianNoise(sigma, security, samples)
    for name in ("tail_bound", "bit_precision", "word_precision",
                 "number_of_barriers", "base_value", "innoise_multiplier",
                 "_flag_ctr1", "_flag_ctr2"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.barriers == j.barriers
    np.testing.assert_array_equal(t.lu_val, j.lu_val)
    np.testing.assert_array_equal(t.lu_flag, j.lu_flag)
    np.testing.assert_array_equal(t.barrier_words, j.barrier_words)
    assert sorted(t.lu2) == sorted(j.lu2)
    js, ts = JStream(KEY), Salsa20Stream(KEY)
    for rlen in (256, 1000, 4096):
        np.testing.assert_array_equal(t.get_noise(ts, rlen),
                                      j.get_noise(js, rlen))
        assert ts.nonce == js.nonce
    rnd = np.frombuffer(Salsa20Stream(KEY).randombytes(
        300 * t.word_precision), dtype=np.uint8).reshape(300, -1)
    np.testing.assert_array_equal(t.get_noise_fixed(rnd),
                                  j.get_noise_fixed(rnd))
    assert tgauss.newton_raphson(130.0, 5.0, 3) == \
        jgauss.newton_raphson(130.0, 5.0, 3)


def test_mpfr_barriers_match_jax():
    if not tmpfr.available():
        with pytest.raises(RuntimeError):
            tmpfr.compute_barriers(4.0, 0.0, 0, 9, 160)
        return
    for args in ((4.0, 0.0, 0, 57, 160), (20.0, 0.25, 0, 301, 176)):
        assert tmpfr.compute_barriers(*args) == jmpfr.compute_barriers(*args)
