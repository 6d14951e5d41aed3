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
    """The kernels read RingContext's blocked tables in the storage dtype,
    as (w, w') pairs."""
    tr = tnfl.ring_from_modulus("u32", 256, 60)
    ctx = tr.context()
    t = tpallas.kernel_tables(tr, "cpu")
    assert t is tpallas.kernel_tables(tr, torch.device("cpu"))
    assert (t.m, t.n, t.log_n, t.bits, t.global_stages) == (2, 256, 8, 32, 0)
    for name, half, arr in (("wp", 0, ctx.omegas),
                            ("iwp", 1, ctx.shoupinvomegas),
                            ("twp", 0, ctx.phis),
                            ("itwp", 0, ctx.invpoly_times_invphis)):
        tab = getattr(t, name)
        assert tab.dtype == torch.int32
        np.testing.assert_array_equal(
            tab[..., half].numpy().view(np.uint32), arr)
    assert t.p.dtype == torch.int32
    np.testing.assert_array_equal(t.p.numpy().view(np.uint32), ctx.p)
    assert not tpallas.supports(tnfl.ring_from_modulus("u32", 128, 60))
    assert not tpallas.supports(tnfl.ring_from_modulus("u64", 256, 62))


def _extremes(x, ring):
    """x with 0 and p - 1 in every channel of every polynomial"""
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        x[..., cm, :3] = 0
        x[..., cm, -3:] = p - 1
    return x


def _shoup(s, ring):
    """floor(s * 2^bits / p), the Shoup companions of s, in Python ints"""
    p = np.array([int(q) for q in ring.moduli[:ring.nmoduli]],
                 dtype=object)[:, None]
    return ((s.astype(object) << ring.repr_bits) // p).astype(ring.dtype)


def chain_matches_interpret_kernels(jchain, tchain, jr, tr, seed):
    """The LWE encrypt and decrypt chains of the port (the twins, and the
    entry points, which run them on the CPU) against the JAX package's chain
    kernels in interpret mode, at batch 2, inputs over the full residue
    range with 0 and p - 1 in every channel, exact."""
    rng = np.random.default_rng(seed)
    u, e1, e2 = (_extremes(rand_residues(jr, rng, batch=(2,)), jr)
                 for _ in range(3))
    pka, pkb, s = (_extremes(rand_residues(jr, rng), jr) for _ in range(3))
    sp = _shoup(s, jr)
    jctx, tctx = jr.context(), tr.context()
    want_a, want_b = (np.asarray(v) for v in jchain.lwe_encrypt_fused(
        u, e1, e2, pka, pkb, jctx, interpret=True))
    want_d = np.asarray(jchain.lwe_decrypt_fused(want_a, want_b, s, sp, jctx,
                                                 interpret=True))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(
            jr.limb_params.signed_dtype).copy())
    for enc, dec in ((tchain.lwe_encrypt_plain, tchain.lwe_decrypt_plain),
                     (tchain.lwe_encrypt_fused, tchain.lwe_decrypt_fused)):
        ra, rb = enc(t(u), t(e1), t(e2), t(pka), t(pkb), tctx)
        np.testing.assert_array_equal(ra.numpy().view(jr.dtype), want_a)
        np.testing.assert_array_equal(rb.numpy().view(jr.dtype), want_b)
        d = dec(t(want_a), t(want_b), t(s), t(sp), tctx)
        np.testing.assert_array_equal(d.numpy().view(jr.dtype), want_d)


@pytest.mark.parametrize("degree,agg,limb", [(256, 14, "u16"),
                                             (512, 60, "u32")])
def test_chains_match_interpret_kernels(degree, agg, limb):
    jr, tr = _both(degree, agg, limb)
    chain_matches_interpret_kernels(jpallas, tpallas, jr, tr, degree + agg)


def test_pair_tables_and_barrett_constants():
    """The chain and butterfly kernels' (w, w') pair tables hold the ring's
    blocked twiddle and twist tables word for word, and bm is
    floor(2^64 / p), for every limb."""
    for limb, degree, agg in (("u16", 256, 14), ("u32", 256, 60),
                              ("u64", 512, 124)):
        tr = tnfl.ring_from_modulus(limb, degree, agg)
        ctx = tr.context()
        t = tpallas.kernel_tables(tr, "cpu")
        for name, (w, ws) in {
                "wp": (ctx.omegas, ctx.shoupomegas),
                "iwp": (ctx.invomegas, ctx.shoupinvomegas),
                "twp": (ctx.phis, ctx.shoupphis),
                "itwp": (ctx.invpoly_times_invphis,
                         ctx.shoupinvpoly_times_invphis)}.items():
            tab = getattr(t, name)
            assert tab.dtype == t.p.dtype and tab.is_contiguous()
            tab = tab.numpy().view(tr.dtype)
            assert tab.shape == w.shape + (2,)
            np.testing.assert_array_equal(tab[..., 0], w)
            np.testing.assert_array_equal(tab[..., 1], ws)
        assert t.bm.dtype == torch.int64
        assert t.bm.numpy().view(np.uint64).tolist() == [
            (1 << 64) // int(p) for p in ctx.p]


def test_barrett_part_reduction_is_exact():
    """The u16/u32 chains' exact product a*b mod p (csrc/ntt_butterfly.cuh
    barrett64) in Python integers: q = hi64(a*b * floor(2^64/p)) is
    floor(a*b/p) or one less, so r = a*b - q*p lies in [0, 2p) and one
    conditional subtraction gives a*b mod p, for every modulus of both tiers
    at the extreme operands (and any 64-bit product)."""
    for limb in ("u16", "u32"):
        lp = tnfl.ring_from_modulus(limb, 256, 14 if limb == "u16"
                                    else 30).limb_params
        for p in lp.P:
            bm = (1 << 64) // p
            ops = (0, 1, 2, p // 2, p - 2, p - 1)
            for v in [a * b for a in ops for b in ops] + [(1 << 64) - 1]:
                r = v - ((v * bm) >> 64) * p
                assert 0 <= r < 2 * p
                assert (r - p if r >= p else r) == v % p
