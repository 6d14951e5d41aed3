"""The u64 tier's NTT against nfllib_tpu: the plain Harvey path against the
jnp path, the fused tables byte for byte, and the plain twins of K4's math
(`_fused64_plain`) and of the route that runs every degree on the card
(`_large_run64`: two launches of K5, csrc/dft_mxu64.cu, the twiddle in the
first one's epilogue) against the JAX Pallas kernels run as the JAX
package's own tests run them on the CPU (interpret mode).  chip_smoke.py
holds the CUDA kernels to these twins on the card.  Integer arithmetic:
exact equality."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt as jntt
from nfllib_tpu.ops import ntt_mxu_u64 as j64
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug, interop
from nfllib_tpu_torch.ops import ntt as tntt
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


def unpack_planes64(words):
    """Inverse of ntt_mxu_u64.pack_planes64: [m, 8, r, c] int64 words ->
    [m, 64, r, c] int8 planes (index 8a + b)."""
    m, _, r, c = words.shape
    b = np.ascontiguousarray(words).view(np.int8).reshape(m, 8, r, c, 8)
    return np.ascontiguousarray(
        b.transpose(0, 1, 4, 2, 3).reshape(m, 64, r, c))


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
def test_tables64_byte_equal(degree, agg, inverse):
    """The port's native-u64 tables equal JAX's hi/lo pairs recombined,
    and the dp4a packing unpacks back to JAX's planes."""
    jr, tr = _both(degree, agg)
    want = j64._tables64(jr, inverse)
    got = t64._tables64(tr, inverse)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:4], want[2:4]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for a, b in zip(got[4:], want[4:]):
        joined = t64._join_pair(b)
        assert a.dtype == np.uint64 and a.shape == joined.shape
        assert a.tobytes() == joined.tobytes()
    t = interop.fused_tables64_from_numpy(want, "cpu")
    np.testing.assert_array_equal(unpack_planes64(t.w1.numpy()), want[2])
    np.testing.assert_array_equal(unpack_planes64(t.w2.numpy()), want[3])
    mine = t64.fused_tables64(tr, inverse, "cpu")
    for name in ("w1", "w2", "tw", "tws", "corr1", "corr2", "p", "mbar"):
        assert torch.equal(getattr(mine, name), getattr(t, name)), name


@pytest.mark.parametrize("degree,agg", TWIN_CONFIGS)
def test_twins_match_interpret_kernel(degree, agg, rng):
    """K4's forward and inverse twins, on the port's tables and on the JAX
    package's tables carried over by interop, against _kernel64 in
    interpret mode."""
    jr, tr = _both(degree, agg)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    f = np.asarray(j64.ntt_pow_phi_fused(x, jctx, interpret=True))
    g = np.asarray(j64.invntt_pow_invphi_fused(f, jctx, interpret=True))
    jax_fwd = interop.fused_tables64_from_numpy(j64._tables64(jr, False),
                                                "cpu")
    jax_inv = interop.fused_tables64_from_numpy(j64._tables64(jr, True),
                                                "cpu")
    for fwd_tabs, inv_tabs in ((None, None), (jax_fwd, jax_inv)):
        tf = t64.ntt_pow_phi_fused_plain(_t(x), tctx, tables=fwd_tabs)
        np.testing.assert_array_equal(_np(tf), f)
        tg = t64.invntt_pow_invphi_fused_plain(_t(f), tctx, tables=inv_tabs)
        np.testing.assert_array_equal(_np(tg), g)
    np.testing.assert_array_equal(g, x)
    # the public entry points take the twin for a CPU tensor
    np.testing.assert_array_equal(
        _np(t64.ntt_pow_phi_fused(_t(x), tctx)), f)
    np.testing.assert_array_equal(
        _np(tntt.invntt_pow_invphi(_t(f), tctx)), g)


def test_recombine64_pack_boundary_exact():
    """The twin's carry-free Barrett pack at the extremes of the group-sum
    contract G_a in [-2^25, 2^25], against Python ints and the JAX
    _recombine64, as test_recombine64_pack_boundary_exact in
    tests/test_ntt_mxu_u64.py."""
    ring = nfl.Ring("u64", 8192, 3)
    gmax = 1 << 25
    combos = [[lo] * 4 + [hi] * 4
              for lo, hi in itertools.product([-gmax, 0, gmax], repeat=2)]
    cases = np.array(combos + np.random.default_rng(11).integers(
        -gmax, gmax + 1, size=(256, 8)).tolist(), dtype=np.int64)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        mbar = (1 << 124) // p
        got = _np(t64._recombine64_plain(
            [torch.from_numpy(cases[:, a].copy()) for a in range(8)],
            torch.tensor(p), torch.tensor(mbar), torch.tensor(0),
            lazy=False))
        pair = tuple(jnp.uint32(v) for v in ((p >> 32), p & 0xFFFFFFFF))
        mpair = tuple(jnp.uint32(v) for v in ((mbar >> 32),
                                              mbar & 0xFFFFFFFF))
        hi, lo = j64._recombine64(
            [jnp.asarray(cases[:, a].astype(np.int32)).reshape(-1, 1, 1)
             for a in range(8)], pair, mpair,
            (jnp.uint32(0), jnp.uint32(0)), strict=True)
        want = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) \
            | np.asarray(lo).astype(np.uint64)
        np.testing.assert_array_equal(got, want.reshape(-1))
        for i in range(cases.shape[0]):
            v = sum((int(cases[i, a]) + t64._BIAS) << (8 * a)
                    for a in range(8))
            assert int(got[i]) == v % p, (cm, i, cases[i])


def test_large_run64_matches_jax_small(rng):
    """The large-degree split path (two mod-matmul twins + plain Shoup
    twiddle) against JAX's _large_run64 in interpret mode, at small
    degrees for speed; dispatch uses it only above 2^16."""
    for deg in (1024, 4096):
        jr, tr = nfl.Ring("u64", deg, 2), tnfl.Ring("u64", deg, 2)
        x = rand_residues(jr, rng)
        want = np.asarray(j64._large_run64(x, jr.context(), False, True))
        got = t64._large_run64(_t(x), tr.context(), False)
        np.testing.assert_array_equal(_np(got), want)
        back = t64._large_run64(got, tr.context(), True)
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


def test_strict_poison_on_broken_contract(rng):
    """Tables that break a stage contract poison the whole (polynomial,
    channel) block with 0xFFFF_FFFF_FFFF_FFFF (as K4 does) only under
    strict mode, and the bracket turns the poison into an AssertionError;
    a residue equal to p raises."""
    jr, tr = _both(512, 124)
    ctx = tr.context()
    t = t64.fused_tables64(tr, False, "cpu")
    # a twiddle that disagrees with its Shoup companion breaks [0, 2p)
    broken = dataclasses.replace(t, tw=torch.full_like(t.tw, (1 << 63) - 1))
    x = _t(rand_residues(jr, rng, batch=(2,)))
    lax = t64.ntt_pow_phi_fused_plain(x, ctx, tables=broken)
    assert not bool((lax == -1).all())
    debug.set_strictmod(True)
    try:
        poisoned = t64.ntt_pow_phi_fused_plain(x, ctx, tables=broken)
        assert bool((poisoned == -1).all())
        with pytest.raises(AssertionError):
            tntt._strict_bracket(
                lambda v: t64.ntt_pow_phi_fused_plain(v, ctx, tables=broken),
                x, ctx)
        tntt.ntt_pow_phi(x, ctx)                     # in range: fine
        bad = x.clone()
        bad[0, 1, 3] = int(tr.moduli[1])
        for fn in (tntt.ntt_pow_phi, tntt.invntt_pow_invphi):
            with pytest.raises(AssertionError):
                fn(bad, ctx)
    finally:
        debug.set_strictmod(False)


def test_kernel_wrappers_refuse_cpu_tensors(rng):
    """On a CPU tensor only the twins run: the u64 NTT's entry points take
    K4's twin and launch nothing; the wrappers of the route's two kernels
    (K5 with the twiddle epilogue, then K5), at the degree-8 ring's sizes
    2 and 4, refuse it instead of falling back, and count nothing."""
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
    tw = t64._large_twiddle_device(tr, False, torch.device("cpu"))
    xs = torch.zeros(1, 2, 2, 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        _kernels.DFT_MXU64_TW(xs, e1, tw)
    with pytest.raises(ValueError):
        _kernels.DFT_MXU64(xs, e2)
    assert [k.launches for k in _kernels.KERNELS] == before


def _route_case(degree, agg, rng):
    """The CUDA route's twin, _large_run64(plain=True) (two mod-matmul
    twins, the twiddle in the first one's epilogue), against the JAX
    _kernel64 in interpret mode and K4's twin, both directions."""
    jr, tr = _both(degree, agg)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    f = np.asarray(j64.ntt_pow_phi_fused(x, jctx, interpret=True))
    g = np.asarray(j64.invntt_pow_invphi_fused(f, jctx, interpret=True))
    got_f = t64._large_run64(_t(x), tctx, False, plain=True)
    np.testing.assert_array_equal(_np(got_f), f)
    assert torch.equal(got_f, t64.ntt_pow_phi_fused_plain(_t(x), tctx))
    got_g = t64._large_run64(_t(f), tctx, True, plain=True)
    np.testing.assert_array_equal(_np(got_g), g)
    assert torch.equal(got_g, t64.invntt_pow_invphi_fused_plain(_t(f), tctx))
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
        valid = t64._large_run64(x, ctx, False, plain=True)
    finally:
        debug.set_strictmod(False)
    assert torch.equal(valid, t64.ntt_pow_phi_fused_plain(x, ctx))
    tw, tws = t64._large_twiddle_device(tr, False, torch.device("cpu"))
    broken = (torch.full_like(tw, (1 << 63) - 1), tws)
    monkeypatch.setattr(t64, "_large_twiddle_device", lambda *args: broken)
    lax = t64._large_run64(x, ctx, False, plain=True)
    assert not bool((lax == -1).any())
    debug.set_strictmod(True)
    try:
        poisoned = t64._large_run64(x, ctx, False, plain=True)
        assert bool((poisoned == -1).all())
        with pytest.raises(AssertionError):
            tntt._strict_bracket(
                lambda v: t64._large_run64(v, ctx, False, plain=True), x, ctx)
    finally:
        debug.set_strictmod(False)
