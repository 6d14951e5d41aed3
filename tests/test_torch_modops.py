"""The port's modular ops against nfllib_tpu.ops.modops (exact equality).

Inputs are made with numpy, fed to both packages; the port's storage
tensors are views of the same bytes."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import modops as jmod
from nfllib_tpu_torch import ring_from_modulus
from nfllib_tpu_torch.ops import modops as tmod

from conftest import CONFIG_MATRIX, make_ring, rand_residues

SMALL = [c for c in CONFIG_MATRIX if c[2] != "u64"]


def _t(arr, ring):
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        ring.limb_params.signed_dtype).copy())


def _np(t, ring):
    return t.numpy().view(ring.dtype)


def _operands(degree, agg, limb, rng, count):
    ring = make_ring(min(degree, 64), agg, limb)
    vals = [rand_residues(ring, rng, batch=(2,)) for _ in range(count)]
    pt = ring_from_modulus(limb, ring.degree, agg).context().to("cpu").p_col
    return ring, vals, jnp.asarray(ring.context().p_col), pt


@pytest.mark.parametrize("degree,agg,limb", SMALL)
def test_add_sub_mul(degree, agg, limb, rng):
    ring, (a, b), pj, pt = _operands(degree, agg, limb, rng, 2)
    ta, tb = _t(a, ring), _t(b, ring)
    for jf, tf in [(jmod.addmod, tmod.addmod), (jmod.submod, tmod.submod)]:
        np.testing.assert_array_equal(
            _np(tf(ta, tb, pt), ring), np.asarray(jf(a, b, pj)))
    pn = jnp.asarray(ring.context().pn_col)
    np.testing.assert_array_equal(
        _np(tmod.mulmod(ta, tb, pt), ring), np.asarray(jmod.mulmod(a, b, pj, pn)))


@pytest.mark.parametrize("degree,agg,limb", SMALL)
def test_shoup_family(degree, agg, limb, rng):
    ring, (r, a, b), pj, pt = _operands(degree, agg, limb, rng, 3)
    tr, ta, tb = _t(r, ring), _t(a, ring), _t(b, ring)
    jprec = np.asarray(jmod.compute_shoup(b, pj))
    tprec = tmod.compute_shoup(tb, pt)
    np.testing.assert_array_equal(_np(tprec, ring), jprec)
    np.testing.assert_array_equal(
        _np(tmod.mulmod_shoup(ta, tb, tprec, pt), ring),
        np.asarray(jmod.mulmod_shoup(a, b, jprec, pj)))
    np.testing.assert_array_equal(
        _np(tmod.mulmod_shoup_lazy(ta, tb, tprec, pt), ring),
        np.asarray(jmod.mulmod_shoup_lazy(a, b, jprec, pj)))
    np.testing.assert_array_equal(
        _np(tmod.muladd_shoup(tr, ta, tb, tprec, pt), ring),
        np.asarray(jmod.muladd_shoup(r, a, b, jprec, pj)))
    pn = jnp.asarray(ring.context().pn_col)
    np.testing.assert_array_equal(
        _np(tmod.muladd(tr, ta, tb, pt), ring),
        np.asarray(jmod.muladd(r, a, b, pj, pn)))
    lazy = _np(tmod.mulmod_shoup_lazy(ta, tb, tprec, pt), ring)
    np.testing.assert_array_equal(
        _np(tmod.reduce_once(_t(lazy, ring), pt), ring),
        np.asarray(jmod.reduce_once(lazy, pj)))


@pytest.mark.parametrize("limb,agg", [("u16", 14), ("u32", 60)])
def test_boundary_values(limb, agg):
    """Worst-case operands (p-1 squared, tiny*huge mixes), as in
    tests/test_modops.py."""
    ring = make_ring(8, agg, limb)
    pv = np.asarray(ring.moduli, dtype=np.uint64)
    picks = np.array([1, 2, 3, 0, 0, 0, 0, 0], dtype=np.uint64)
    a = ((pv[:, None] - 1 - picks[None, :]) % pv[:, None]).astype(ring.dtype)
    picks2 = np.array([1, 0, 1, 2, 1, 0, 2, 1], dtype=np.uint64)
    b = np.where(picks2[None, :] == 0, pv[:, None] - 1,
                 picks2[None, :]).astype(ring.dtype)
    r = (b.astype(np.uint64) * 3 % pv[:, None]).astype(ring.dtype)
    pj = jnp.asarray(ring.context().p_col)
    pn = jnp.asarray(ring.context().pn_col)
    pt = ring_from_modulus(limb, 8, agg).context().to("cpu").p_col
    ta, tb, tr = _t(a, ring), _t(b, ring), _t(r, ring)
    np.testing.assert_array_equal(_np(tmod.mulmod(ta, tb, pt), ring),
                                  np.asarray(jmod.mulmod(a, b, pj, pn)))
    np.testing.assert_array_equal(_np(tmod.muladd(tr, ta, tb, pt), ring),
                                  np.asarray(jmod.muladd(r, a, b, pj, pn)))
    np.testing.assert_array_equal(_np(tmod.addmod(ta, tb, pt), ring),
                                  np.asarray(jmod.addmod(a, b, pj)))
    np.testing.assert_array_equal(_np(tmod.submod(tb, ta, pt), ring),
                                  np.asarray(jmod.submod(b, a, pj)))
    tprec = tmod.compute_shoup(tb, pt)
    np.testing.assert_array_equal(
        _np(tmod.mulmod_shoup(ta, tb, tprec, pt), ring),
        np.asarray(jmod.mulmod_shoup(a, b, jmod.compute_shoup(b, pj), pj)))


@pytest.mark.parametrize("limb,wbits", [("u16", 16), ("u32", 32)])
def test_compute_shoup_near_multiples_of_p(limb, wbits):
    """Unreduced inputs over the whole word, including every value next to
    a multiple of p, as in tests/test_modops.py; u32 companions >= 2^31
    read negative in int32 storage."""
    lp = nfl.get_limb_params(limb)
    dt = np.uint16 if limb == "u16" else np.uint32
    sdt = np.int16 if limb == "u16" else np.int32
    rng = np.random.default_rng(11)
    for p_ in [int(v) for v in lp.P[:4]]:
        ks = np.arange(1, min((1 << wbits) // p_, 4096), dtype=object)
        near = np.concatenate([ks * p_ - 1, ks * p_, ks * p_ + 1,
                               rng.integers(0, 1 << wbits, 4096),
                               np.array([0, 1, (1 << wbits) - 1],
                                        dtype=object)])
        near = np.array([v for v in near if 0 <= v < (1 << wbits)],
                        dtype=np.uint64).astype(dt)
        want = np.asarray(jmod.compute_shoup(
            jnp.asarray(near), jnp.asarray(np.array(p_, dtype=dt))))
        got = tmod.compute_shoup(torch.from_numpy(near.view(sdt).copy()),
                                 torch.tensor(p_, dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy().view(dt), want)


def test_u64_storage_is_not_ported():
    """u64 storage is int64 and is ported now: addmod on it equals the JAX
    package's, including sums that pass 2^63 before the reduction."""
    ring = make_ring(8, 124, "u64")
    pv = np.asarray(ring.moduli, dtype=np.uint64)[:, None]
    a = np.repeat(pv - np.uint64(1), 8, axis=1)
    b = (pv - np.arange(1, 9, dtype=np.uint64)[None, :]).astype(np.uint64)
    pt = ring_from_modulus("u64", 8, 124).context().to("cpu").p_col
    got = tmod.addmod(torch.from_numpy(a.view(np.int64).copy()),
                      torch.from_numpy(b.view(np.int64).copy()), pt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy().view(np.uint64),
        np.asarray(jmod.addmod(a, b, jnp.asarray(ring.context().p_col))))
