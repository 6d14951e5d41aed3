"""The u64 tier's NTT against nfllib_tpu: the plain Harvey path against the
jnp path, the route's matrices and twiddle against the JAX kernel's tables,
and the twin of the route that runs every degree (ops/ntt_mxu.py:_route:
two launches of K5, csrc/dft_mxu64.cu, the twiddle in the first one's
epilogue; the same stages' twin on a CPU tensor) against the JAX Pallas
kernels run as the JAX package's own tests run them on the CPU (interpret
mode).  chip_smoke.py holds the CUDA kernels to these twins on the card.
Integer arithmetic: exact equality."""
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as jntt
from nfllib_tpu.ops import ntt_mxu_u64 as j64
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug, interop
from nfllib_tpu_torch.ops import dft_mxu as tdft
from nfllib_tpu_torch.ops import ntt as tntt
from nfllib_tpu_torch.ops import ntt_mxu as tmxu
from nfllib_tpu_torch.ops import ntt_mxu_u64 as t64

from conftest import rand_residues

TWIN_CONFIGS = [(64, 124), (256, 62), (512, 124), (8192, 124)]


def _both(degree, agg):
    return (nfl.ring_from_modulus("u64", degree, agg),
            tnfl.ring_from_modulus("u64", degree, agg))


def _t(arr):
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint64)
                            .view(np.int64).copy())


def _np(t):
    return t.numpy().view(np.uint64)


def test_supports_and_geometry_match():
    for lg in range(0, 21):
        jr, tr = nfl.Ring("u64", 1 << lg, 1), tnfl.Ring("u64", 1 << lg, 1)
        assert t64.supports_fused(tr) == j64.supports_fused(jr), lg
        if lg >= 3:
            assert t64._geometry(1 << lg) == j64._geometry(1 << lg)
    assert not t64.supports_fused(tnfl.Ring("u32", 8192, 2))


@pytest.mark.parametrize("degree,agg", [(1, 124), (2, 124), (32, 124),
                                        (512, 124)])
def test_plain_harvey_matches_jnp(degree, agg, rng):
    """ntt / inv_ntt in int64 read as unsigned, against the jnp path; the
    fused-free dispatch at degrees 1 and 2."""
    jr, tr = _both(degree, agg)
    x = rand_residues(jr, rng, batch=(2,))
    tx = _t(x)
    for kw in ({}, {"inverse_tables": True}):
        want = np.asarray(jntt.ntt(x, jr.context(), **kw))
        np.testing.assert_array_equal(_np(tntt.ntt(tx, tr.context(), **kw)),
                                      want)
    np.testing.assert_array_equal(_np(tntt.inv_ntt(tx, tr.context())),
                                  np.asarray(jntt.inv_ntt(x, jr.context())))
    if degree < 8:
        assert not t64.supports_fused(tr)
        want = np.asarray(jntt.ntt_pow_phi(x, jr.context()))
        got = tntt.ntt_pow_phi(tx, tr.context())
        np.testing.assert_array_equal(_np(got), want)
        np.testing.assert_array_equal(
            _np(tntt.invntt_pow_invphi(got, tr.context())), x)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree,agg", [(64, 124), (512, 124)])
def test_route_tables_equal_jax_tables64(degree, agg, inverse):
    """The route's matrices and twiddle (native u64) are byte-equal to the
    JAX kernel _kernel64's own, recovered from its digit planes and hi/lo
    pairs by interop."""
    jr, tr = _both(degree, agg)
    got = interop.fused_tables64_from_numpy(j64._tables64(jr, inverse))
    n1, n2 = t64._geometry(degree)
    d = "inv" if inverse else "fwd"
    want = (tdft._MATRIX_PROVIDERS[f"ntt64_e1_{d}"](tr, n1),
            tdft._MATRIX_PROVIDERS[f"ntt64_e2_{d}"](tr, n2),
            *tmxu._twiddle(tr, inverse))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint64 and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("degree,agg", TWIN_CONFIGS)
def test_twins_match_interpret_kernel(degree, agg, rng):
    """The public twins (the route's) and entry points on a CPU tensor,
    forward and inverse, against _kernel64 in interpret mode."""
    jr, tr = _both(degree, agg)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    f = np.asarray(j64.ntt_pow_phi_fused(x, jctx, interpret=True))
    g = np.asarray(j64.invntt_pow_invphi_fused(f, jctx, interpret=True))
    np.testing.assert_array_equal(_np(t64.ntt_pow_phi_fused_plain(_t(x),
                                                                  tctx)), f)
    np.testing.assert_array_equal(
        _np(t64.invntt_pow_invphi_fused_plain(_t(f), tctx)), g)
    np.testing.assert_array_equal(g, x)
    np.testing.assert_array_equal(
        _np(t64.ntt_pow_phi_fused(_t(x), tctx)), f)
    np.testing.assert_array_equal(
        _np(tntt.invntt_pow_invphi(_t(f), tctx)), g)


@pytest.mark.parametrize("inverse", [False, True])
def test_route_twiddle_equals_jax_large_twiddle(inverse):
    """The route's u64 twiddle and its 64-bit Shoup companions equal the
    JAX package's _large_twiddle (the twiddle of its _large_run64)."""
    jr, tr = _both(1024, 124)
    for a, b in zip(tmxu._twiddle(tr, inverse),
                    j64._large_twiddle(jr, inverse)):
        assert a.dtype == np.asarray(b).dtype == np.uint64
        assert a.tobytes() == np.asarray(b).tobytes()


def test_large_run64_matches_jax_small(rng):
    """The route (two mod-matmul twins, the twiddle in the first one's
    epilogue) against JAX's _large_run64 (its twiddle a separate Shoup
    product) in interpret mode, at small degrees for speed."""
    for deg in (1024, 4096):
        jr, tr = nfl.Ring("u64", deg, 2), tnfl.Ring("u64", deg, 2)
        x = rand_residues(jr, rng)
        want = np.asarray(j64._large_run64(x, jr.context(), False, True))
        got = tmxu._route(_t(x), tr.context(), False)
        np.testing.assert_array_equal(_np(got), want)
        back = tmxu._route(got, tr.context(), True)
        np.testing.assert_array_equal(_np(back), x)


@pytest.mark.slow
def test_large_degree_dispatch_2pow17(rng):
    """Degrees > 2^16 dispatch through the split path: equal to the plain
    Harvey path and exactly invertible, as in tests/test_ntt_mxu_u64.py."""
    tr = tnfl.Ring("u64", 1 << 17, 1)
    assert t64.supports_fused(tr)
    ctx = tr.context()
    x = _t(rand_residues(nfl.Ring("u64", 1 << 17, 1), rng))
    tabs = ctx.to("cpu")
    from nfllib_tpu_torch.ops import modops
    want = tntt.ntt(modops.mulmod_shoup(x, tabs.phis, tabs.shoupphis,
                                        tabs.p_col), ctx)
    got = tntt.ntt_pow_phi(x, ctx)
    assert torch.equal(got, want)
    assert torch.equal(tntt.invntt_pow_invphi(got, ctx), x)


def test_quickstart_product_u64_byte_identical():
    """The README quick-start product on a u64 ring through both packages,
    byte-identical, from the same Salsa20 key."""
    from nfllib_tpu.prng import Salsa20Stream as JStream
    from nfllib_tpu_torch.prng import Salsa20Stream
    key = bytes(range(32))
    out = []
    for lib, stream in ((nfl, JStream(key)), (tnfl, Salsa20Stream(key))):
        ring = lib.ring_from_modulus("u64", 64, 124)
        kw = {"device": "cpu"} if lib is tnfl else {}
        a = lib.Poly.sample(ring, lib.uniform(), stream, **kw)
        b = lib.Poly.sample(ring, lib.uniform(), stream, **kw)
        fb = b.ntt_pow_phi()
        c = lib.shoup(a.ntt_pow_phi() * fb,
                      lib.compute_shoup(fb)).invntt_pow_invphi()
        out.append([np.asarray(p.data) if lib is nfl else p.numpy()
                    for p in (a, b, fb, c)])
    for j, t in zip(*out):
        assert j.dtype == t.dtype == np.uint64 and j.tobytes() == t.tobytes()


def test_strict_poison_on_broken_contract(rng, monkeypatch):
    """Through the dispatch (ops/ntt.py) under strict mode: a valid
    transform passes; a twiddle that disagrees with its Shoup companion
    poisons the blocks and the bracket raises; a residue equal to p
    raises in both directions."""
    jr, tr = _both(512, 124)
    ctx = tr.context()
    x = _t(rand_residues(jr, rng, batch=(2,)))
    bad = x.clone()
    bad[0, 1, 3] = int(tr.moduli[1])
    tw, tws = tmxu._twiddle_device(tr, False, torch.device("cpu"))
    debug.set_strictmod(True)
    try:
        assert torch.equal(tntt.ntt_pow_phi(x, ctx),
                           t64.ntt_pow_phi_fused_plain(x, ctx))
        for fn in (tntt.ntt_pow_phi, tntt.invntt_pow_invphi):
            with pytest.raises(AssertionError):
                fn(bad, ctx)
        monkeypatch.setattr(tmxu, "_twiddle_device", lambda *args: (
            torch.full_like(tw, (1 << 63) - 1), tws))
        assert bool((t64.ntt_pow_phi_fused_plain(x, ctx) == -1).all())
        with pytest.raises(AssertionError):
            tntt.ntt_pow_phi(x, ctx)
    finally:
        debug.set_strictmod(False)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """On a CPU tensor only the twins run: the u64 NTT's entry points take
    the route's twin and launch nothing; the wrappers of the route's two
    kernels (K5 with the twiddle epilogue, then K5), at the degree-8
    ring's sizes 2 and 4, refuse it instead of falling back, and count
    nothing."""
    from nfllib_tpu_torch import _kernels
    from nfllib_tpu_torch.ops import dft_mxu
    tr = tnfl.Ring("u64", 8, 2)
    assert t64._geometry(8) == (2, 4)
    before = [k.launches for k in _kernels.KERNELS]
    x = _t(rand_residues(nfl.Ring("u64", 8, 2), rng, batch=(1,)))
    f = t64.ntt_pow_phi_fused(x, tr.context())
    assert torch.equal(f, t64.ntt_pow_phi_fused_plain(x, tr.context()))
    e1 = dft_mxu.dft_tables(tr, "ntt64_e1_fwd", 2, True, "cpu")
    e2 = dft_mxu.dft_tables(tr, "ntt64_e2_fwd", 4, False, "cpu")
    tw = tmxu._twiddle_device(tr, False, torch.device("cpu"))
    xs = torch.zeros(1, 2, 2, 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        _kernels.DFT_MXU64_TW(xs, e1, tw)
    with pytest.raises(ValueError):
        _kernels.DFT_MXU64(xs, e2)
    assert [k.launches for k in _kernels.KERNELS] == before


def _route_case(degree, agg, rng):
    """The CUDA route's twin, _route(plain=True) (two mod-matmul twins, the
    twiddle in the first one's epilogue), against the JAX _kernel64 in
    interpret mode and the public entry points on a CPU tensor, both
    directions."""
    jr, tr = _both(degree, agg)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    f = np.asarray(j64.ntt_pow_phi_fused(x, jctx, interpret=True))
    g = np.asarray(j64.invntt_pow_invphi_fused(f, jctx, interpret=True))
    got_f = tmxu._route(_t(x), tctx, False, plain=True)
    np.testing.assert_array_equal(_np(got_f), f)
    assert torch.equal(got_f, t64.ntt_pow_phi_fused(_t(x), tctx))
    got_g = tmxu._route(_t(f), tctx, True, plain=True)
    np.testing.assert_array_equal(_np(got_g), g)
    assert torch.equal(got_g, t64.invntt_pow_invphi_fused(_t(f), tctx))
    np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("degree,agg", [(8, 124), (16, 62), (32, 124),
                                        (64, 124), (512, 124)])
def test_route_twin_matches_interpret_kernel(degree, agg, rng):
    """Degrees 8..512, sides 2..32: the small ones run the mod-matmul at
    sizes 2 and 4, which matmul_mod refuses."""
    _route_case(degree, agg, rng)


@pytest.mark.slow
@pytest.mark.parametrize("degree,agg", [(1 << 14, 124), (1 << 16, 62)])
def test_route_twin_matches_interpret_kernel_large(degree, agg, rng):
    _route_case(degree, agg, rng)


def test_route_strict_poison(rng, monkeypatch):
    """Under strict mode a twiddle that disagrees with its Shoup companion
    poisons every (polynomial, channel) block through both stages of the
    route's twin (the second stage sees poisoned inputs), and the bracket
    raises; without strict mode nothing is poisoned."""
    jr, tr = _both(64, 124)
    ctx = tr.context()
    x = _t(rand_residues(jr, rng, batch=(2,)))
    debug.set_strictmod(True)
    try:
        valid = tmxu._route(x, ctx, False, plain=True)
    finally:
        debug.set_strictmod(False)
    assert torch.equal(valid, t64.ntt_pow_phi_fused_plain(x, ctx))
    tw, tws = tmxu._twiddle_device(tr, False, torch.device("cpu"))
    broken = (torch.full_like(tw, (1 << 63) - 1), tws)
    monkeypatch.setattr(tmxu, "_twiddle_device", lambda *args: broken)
    lax = tmxu._route(x, ctx, False, plain=True)
    assert not bool((lax == -1).any())
    debug.set_strictmod(True)
    try:
        poisoned = tmxu._route(x, ctx, False, plain=True)
        assert bool((poisoned == -1).all())
        with pytest.raises(AssertionError):
            tntt._strict_bracket(
                lambda v: tmxu._route(v, ctx, False, plain=True), x, ctx)
    finally:
        debug.set_strictmod(False)
