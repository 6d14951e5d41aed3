"""The port's butterfly NTT (K3's twin, ops/ntt_pallas.py) against
nfllib_tpu: the jnp path for every flag combination, and the Pallas kernel
in interpret mode, exact equality.  On the CPU ntt_fwd / intt_bwd run the
plain twin, the arithmetic of csrc/ntt_butterfly.cu."""
import functools
import itertools

import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as jntt
from nfllib_tpu.ops import ntt_pallas as jpallas
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch.ops import modops
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import ntt_pallas as tpallas

from conftest import rand_residues

# (degree, modulus bits, limb, batch): odd batch shapes
CONFIGS = [(256, 14, "u16", (3,)), (512, 28, "u16", (1, 5)),
           (256, 60, "u32", ()), (1024, 90, "u32", (3,))]


def _both(degree, agg, limb):
    return (nfl.ring_from_modulus(limb, degree, agg),
            tnfl.ring_from_modulus(limb, degree, agg))


def _t(arr, ring):
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        ring.limb_params.signed_dtype).copy())


def _np(t, ring):
    return t.numpy().view(ring.dtype)


@functools.lru_cache(maxsize=None)
def _jax_ref(degree, agg, limb, batch):
    """Inputs and the jnp path's outputs, computed once per config:
    x, ntt_pow_phi(x), ntt(x), ntt(x, omega^-1), inv_ntt(f),
    invntt_pow_invphi(f) with f = ntt_pow_phi(x)."""
    jr = nfl.ring_from_modulus(limb, degree, agg)
    jctx = jr.context()
    x = rand_residues(jr, np.random.default_rng(degree + len(batch)),
                      batch=batch)
    f = np.asarray(jntt.ntt_pow_phi(x, jctx))
    return (x, f, np.asarray(jntt.ntt(x, jctx)),
            np.asarray(jntt.ntt(x, jctx, inverse_tables=True)),
            np.asarray(jntt.inv_ntt(f, jctx)),
            np.asarray(jntt.invntt_pow_invphi(f, jctx)))


@pytest.mark.parametrize("degree,agg,limb,batch", CONFIGS)
def test_forward_flags_match_jnp(degree, agg, limb, batch):
    """ntt_fwd with every (inverse_tables, twist, strict): strict outputs
    equal the jnp path's ntt_pow_phi / ntt; lazy outputs lie in [0, 2p)
    and reduce to them."""
    jr, tr = _both(degree, agg, limb)
    tctx = tr.context()
    x, f, plain, plain_inv = _jax_ref(degree, agg, limb, batch)[:4]
    p = tctx.to("cpu").p_col
    for inv, twist, strict in itertools.product((False, True), repeat=3):
        if twist:
            if inv:
                continue          # the jnp path has no twisted omega^-1 pass
            want = f
        else:
            want = plain_inv if inv else plain
        got = tpallas.ntt_fwd(_t(x, jr), tctx, inverse_tables=inv,
                              twist=twist, strict=strict)
        if not strict:
            v = modops.widen(got, tr.repr_bits)
            assert bool((v < 2 * p).all())
            got = modops.reduce_once(got, p)
        np.testing.assert_array_equal(_np(got, jr), want)


@pytest.mark.parametrize("degree,agg,limb,batch", CONFIGS)
def test_inverse_flags_match_jnp(degree, agg, limb, batch):
    """intt_bwd (stage inversion) with every (untwist, strict) against the
    jnp path's invntt_pow_invphi and inv_ntt (bit reversal, forward pass
    with omega^-1, bit reversal)."""
    jr, tr = _both(degree, agg, limb)
    tctx = tr.context()
    x, f, _, _, raw_inv, inv = _jax_ref(degree, agg, limb, batch)
    np.testing.assert_array_equal(inv, x)
    p = tctx.to("cpu").p_col
    for untwist, strict in itertools.product((False, True), repeat=2):
        want = x if untwist else raw_inv
        got = tpallas.intt_bwd(_t(f, jr), tctx, untwist=untwist,
                               strict=strict)
        if not strict:
            assert bool((modops.widen(got, tr.repr_bits) < 2 * p).all())
            got = modops.reduce_once(got, p)
        np.testing.assert_array_equal(_np(got, jr), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_twin_matches_interpret_kernel(inverse, rng):
    """One case per direction against the Pallas kernel in interpret mode,
    lazy outputs (strict=False) included: the twin computes what the TPU
    kernel computes, word for word."""
    jr, tr = _both(256, 60, "u32")
    x = rand_residues(jr, rng, batch=(2,))
    for strict in (True, False):
        if inverse:
            want = jpallas.intt_bwd(x, jr.context(), strict=strict,
                                    interpret=True)
            got = tpallas.intt_bwd(_t(x, jr), tr.context(), strict=strict)
        else:
            want = jpallas.ntt_fwd(x, jr.context(), strict=strict,
                                   interpret=True)
            got = tpallas.ntt_fwd(_t(x, jr), tr.context(), strict=strict)
        np.testing.assert_array_equal(_np(got, jr), np.asarray(want))


@pytest.mark.parametrize("degree,agg,limb,batch", CONFIGS)
def test_butterfly_mode_dispatch_matches_jnp(degree, agg, limb, batch,
                                             monkeypatch):
    """NFL_TORCH_NTT=butterfly sends ntt_pow_phi, invntt_pow_invphi, ntt and
    inv_ntt through ops/ntt_pallas.py (its twin on the CPU), with the same
    results as the jnp path."""
    monkeypatch.setenv("NFL_TORCH_NTT", "butterfly")
    jr, tr = _both(degree, agg, limb)
    tctx = tr.context()
    x, f, plain, _, raw_inv, _ = _jax_ref(degree, agg, limb, batch)
    tx = _t(x, jr)
    assert tntt._butterfly_module(tr, tx) is tpallas
    assert tntt._fused_module(tr) is None
    tf = tntt.ntt_pow_phi(tx, tctx)
    np.testing.assert_array_equal(_np(tf, jr), f)
    np.testing.assert_array_equal(_np(tntt.invntt_pow_invphi(tf, tctx), jr),
                                  x)
    np.testing.assert_array_equal(_np(tntt.ntt(tx, tctx), jr), plain)
    np.testing.assert_array_equal(_np(tntt.inv_ntt(tf, tctx), jr), raw_inv)


def test_kernel_tables_are_the_ring_tables():
    """The kernel reads RingContext's blocked tables in the storage dtype."""
    tr = tnfl.ring_from_modulus("u32", 256, 60)
    ctx = tr.context()
    t = tpallas.kernel_tables(tr, "cpu")
    assert t is tpallas.kernel_tables(tr, torch.device("cpu"))
    assert (t.m, t.n, t.log_n, t.bits, t.global_stages) == (2, 256, 8, 32, 0)
    for name, arr in (("w", ctx.omegas), ("iws", ctx.shoupinvomegas),
                      ("tw", ctx.phis), ("itw", ctx.invpoly_times_invphis),
                      ("p", ctx.p)):
        tab = getattr(t, name)
        assert tab.dtype == torch.int32
        np.testing.assert_array_equal(tab.numpy().view(np.uint32), arr)
    assert not tpallas.supports(tnfl.ring_from_modulus("u32", 128, 60))
    assert not tpallas.supports(tnfl.ring_from_modulus("u64", 256, 62))
