"""The port's u64 (62-bit) modular ops against nfllib_tpu.ops.modops and
exact Python integers.

u64 residues are int64 tensors holding the uint64 bit pattern; the numpy
boundary is a `.view(np.uint64)`.  Every comparison is exact equality."""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import modops as jmod
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug
from nfllib_tpu_torch.ops import modops as tmod

from conftest import rand_residues

M64 = (1 << 64) - 1
EDGES = [0, 1, 2, 3, (1 << 32) - 1, 1 << 32, (1 << 62) - 1, 1 << 62,
         (1 << 62) + 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64 - 1, M64]


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint64)
                            .view(np.int64).copy())


def _np(t):
    return t.numpy().view(np.uint64)


def _words(rng, count):
    """Edge words plus random words over the whole 64-bit range."""
    rand = rng.integers(0, 1 << 63, size=count, dtype=np.uint64) \
        * np.uint64(2) + rng.integers(0, 2, size=count, dtype=np.uint64)
    return np.concatenate([np.array(EDGES, dtype=np.uint64), rand])


def _ring(degree=8, agg=124):
    return (nfl.ring_from_modulus("u64", degree, agg),
            tnfl.ring_from_modulus("u64", degree, agg))


def test_word_arithmetic_against_python_ints():
    """int64 `*`, `+`, `<<` wrap modulo 2^64 (two's complement) on this
    device, and the unsigned helpers built on them are exact, at the
    extremes 0, 1, 2^62 +- 1, 2^63 - 1, 2^63, 2^64 - 1 and beyond."""
    rng = np.random.default_rng(3)
    w = _words(rng, 50)
    a, b = (np.array(v, dtype=np.uint64)
            for v in zip(*itertools.product(w, w)))
    ta, tb = _t(a), _t(b)
    ia, ib = [int(v) for v in a], [int(v) for v in b]
    hi, lo = tmod.mul128(ta, tb)
    assert _np(hi).tolist() == [(x * y) >> 64 for x, y in zip(ia, ib)]
    assert _np(lo).tolist() == [(x * y) & M64 for x, y in zip(ia, ib)]
    assert _np(tmod.mulhi64(ta, tb)).tolist() == _np(hi).tolist()
    assert _np(tmod.mullo64(ta, tb)).tolist() == _np(lo).tolist()
    assert _np(ta + tb).tolist() == [(x + y) & M64 for x, y in zip(ia, ib)]
    assert _np(ta - tb).tolist() == [(x - y) & M64 for x, y in zip(ia, ib)]
    assert tmod.uge(ta, tb).tolist() == [x >= y for x, y in zip(ia, ib)]
    assert tmod.ult(ta, tb).tolist() == [x < y for x, y in zip(ia, ib)]
    for k in (1, 2, 28, 32, 61, 63):
        assert _np(tmod.srl(ta, k)).tolist() == [x >> k for x in ia]
        assert _np(ta << k).tolist() == [(x << k) & M64 for x in ia]


@pytest.mark.parametrize("degree,agg", [(32, 124), (512, 124), (64, 496)])
def test_ops_match_jax_on_residues(degree, agg, rng):
    jr, tr = _ring(degree, agg)
    r, a, b = (rand_residues(jr, rng, batch=(2,)) for _ in range(3))
    pj = jnp.asarray(jr.context().p_col)
    pn = jnp.asarray(jr.context().pn_col)
    tabs = tr.context().to("cpu")
    p, tpn = tabs.p_col, tabs.pn_col
    tr_, ta, tb = _t(r), _t(a), _t(b)
    for jf, tf in [(jmod.addmod, tmod.addmod), (jmod.submod, tmod.submod)]:
        np.testing.assert_array_equal(_np(tf(ta, tb, p)),
                                      np.asarray(jf(a, b, pj)))
    np.testing.assert_array_equal(_np(tmod.mulmod(ta, tb, p, tpn)),
                                  np.asarray(jmod.mulmod(a, b, pj, pn)))
    np.testing.assert_array_equal(_np(tmod.muladd(tr_, ta, tb, p, tpn)),
                                  np.asarray(jmod.muladd(r, a, b, pj, pn)))
    jprec = np.asarray(jmod.compute_shoup(b, jr.context().p_col))
    tprec = tmod.compute_shoup(tb, p, tabs.shoup_f)
    np.testing.assert_array_equal(_np(tprec), jprec)
    np.testing.assert_array_equal(_np(tmod.compute_shoup(tb, p)), jprec)
    np.testing.assert_array_equal(
        _np(tmod.mulmod_shoup(ta, tb, tprec, p)),
        np.asarray(jmod.mulmod_shoup(a, b, jprec, pj)))
    lazy = tmod.mulmod_shoup_lazy(ta, tb, tprec, p)
    np.testing.assert_array_equal(
        _np(lazy), np.asarray(jmod.mulmod_shoup_lazy(a, b, jprec, pj)))
    np.testing.assert_array_equal(
        _np(tmod.reduce_once(lazy, p)),
        np.asarray(jmod.reduce_once(_np(lazy), pj)))
    np.testing.assert_array_equal(
        _np(tmod.muladd_shoup(tr_, ta, tb, tprec, p)),
        np.asarray(jmod.muladd_shoup(r, a, b, jprec, pj)))


def test_ops_match_jax_on_noncanonical_words():
    """Words the JAX functions accept but that are no residues (lazy
    values < 2p, words >= 2^63): the port's results are the same words."""
    jr, tr = _ring(8, 124)
    rng = np.random.default_rng(5)
    w = _words(rng, 6)[None, :].repeat(2, axis=0)       # [m, n]
    a = w
    b = np.roll(w, 3, axis=1)
    r = np.roll(w, 7, axis=1)
    pj = jnp.asarray(jr.context().p_col)
    pn = jnp.asarray(jr.context().pn_col)
    tabs = tr.context().to("cpu")
    p, tpn = tabs.p_col, tabs.pn_col
    ta, tb, tr_ = _t(a), _t(b), _t(r)
    cases = [
        (tmod.addmod(ta, tb, p), jmod.addmod(a, b, pj)),
        (tmod.submod(ta, tb, p), jmod.submod(a, b, pj)),
        (tmod.mulmod(ta, tb, p, tpn), jmod.mulmod(a, b, pj, pn)),
        (tmod.muladd(tr_, ta, tb, p, tpn), jmod.muladd(r, a, b, pj, pn)),
        (tmod.mulmod_shoup(ta, tb, tr_, p),
         jmod.mulmod_shoup(a, b, r, pj)),
        (tmod.mulmod_shoup_lazy(ta, tb, tr_, p),
         jmod.mulmod_shoup_lazy(a, b, r, pj)),
        (tmod.muladd_shoup(tr_, ta, tb, tr_, p),
         jmod.muladd_shoup(r, a, b, r, pj)),
        (tmod.reduce_once(ta, p), jmod.reduce_once(a, pj)),
        (tmod.compute_shoup(ta, p), jmod.compute_shoup(
            jnp.asarray(a), jr.context().p_col)),
    ]
    for i, (got, want) in enumerate(cases):
        np.testing.assert_array_equal(_np(got), np.asarray(want),
                                      err_msg=str(i))


def test_boundary_values():
    """Worst-case operands for the Newton quotient's error bound (p-1
    squared, tiny*huge mixes), as in tests/test_modops.py, against the
    JAX package and Python ints."""
    jr, tr = _ring(8, 124)
    pv = np.asarray(jr.moduli, dtype=np.uint64)
    picks = np.array([1, 2, 3, 0, 0, 0, 0, 0], dtype=np.uint64)
    a = (pv[:, None] - 1 - picks[None, :]) % pv[:, None]
    picks2 = np.array([1, 0, 1, 2, 1, 0, 2, 1], dtype=np.uint64)
    b = np.where(picks2[None, :] == 0, pv[:, None] - 1, picks2[None, :])
    r = (b.astype(object) * 3 % pv[:, None].astype(object)).astype(np.uint64)
    pj = jnp.asarray(jr.context().p_col)
    pn = jnp.asarray(jr.context().pn_col)
    tabs = tr.context().to("cpu")
    got = _np(tmod.mulmod(_t(a), _t(b), tabs.p_col, tabs.pn_col))
    np.testing.assert_array_equal(got, np.asarray(jmod.mulmod(a, b, pj, pn)))
    for cm in range(2):
        p = int(pv[cm])
        assert got[cm].tolist() == [int(x) * int(y) % p
                                    for x, y in zip(a[cm], b[cm])]
    np.testing.assert_array_equal(
        _np(tmod.muladd(_t(r), _t(a), _t(b), tabs.p_col, tabs.pn_col)),
        np.asarray(jmod.muladd(r, a, b, pj, pn)))


def test_compute_shoup_near_multiples_of_p():
    """Unreduced words over the whole 64-bit range, including values next
    to multiples of p: the port equals the JAX package and
    floor((y mod p) 2^64 / p)."""
    lp = tnfl.get_limb_params("u64")
    rng = np.random.default_rng(11)
    for p in [int(v) for v in lp.P[:3]] + [int(lp.P[-1])]:
        ks = np.arange(1, (1 << 64) // p + 1, dtype=object)
        near = np.concatenate([ks * p - 1, ks * p, ks * p + 1,
                               np.array(EDGES, dtype=object),
                               _words(rng, 256).astype(object)])
        near = np.array([v for v in near if 0 <= v <= M64], dtype=np.uint64)
        want = np.asarray(jmod.compute_shoup(
            jnp.asarray(near), np.array(p, dtype=np.uint64)))
        got = _np(tmod.compute_shoup(_t(near),
                                     torch.tensor(p, dtype=torch.int64)))
        np.testing.assert_array_equal(got, want)
        assert got.tolist() == [((int(v) % p) << 64) // p for v in near]


def test_strict_checks_on_int64_storage():
    """check_residues reads int64 storage as signed: p and every word
    >= 2^63 (the poison word 0xFFFF_FFFF_FFFF_FFFF reads -1) are out of
    range."""
    _, tr = _ring(8, 124)
    p = tr.context().to("cpu").p_col
    ok = torch.zeros(2, 8, dtype=torch.int64)
    ok[:, 1] = p[:, 0] - 1
    debug.set_strictmod(True)
    try:
        debug.check_residues(ok, p)
        for bad_word in (int(tr.moduli[0]), (1 << 63) - 1, -1, -(1 << 63)):
            bad = ok.clone()
            bad[0, 3] = bad_word
            with pytest.raises(AssertionError):
                debug.check_residues(bad, p)
            with pytest.raises(AssertionError):
                tmod.addmod(bad, ok, p)
    finally:
        debug.set_strictmod(False)
