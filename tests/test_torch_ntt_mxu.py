"""The fused NTT's tables and plain twins against nfllib_tpu.ops.ntt_mxu.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
in interpret mode.  The twins are the plain version of
nfllib_tpu_torch/csrc/ntt_fused.cu (chip_smoke.py holds the kernel to them
on the card).  Everything is integer arithmetic: exact equality."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import nfllib_tpu as nfl
from nfllib_tpu.ops import ntt_mxu as jmxu
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug, interop
from nfllib_tpu_torch.ops import ntt_mxu as tmxu

from conftest import rand_residues

TWIN_CONFIGS = [(8, 60, "u32"), (128, 14, "u16"), (512, 14, "u16"),
                (1024, 60, "u32"), (4096, 60, "u32")]
TABLE_CONFIGS = TWIN_CONFIGS + [(16384, 510, "u32")]


def _both(degree, agg, limb):
    return (nfl.ring_from_modulus(limb, degree, agg),
            tnfl.ring_from_modulus(limb, degree, agg))


def _t(arr, ring):
    return torch.from_numpy(np.ascontiguousarray(arr).view(
        ring.limb_params.signed_dtype).copy())


def unpack_planes(wp, ndig):
    """Inverse of ntt_mxu.pack_planes: [m, ndig, r, c] int32 words ->
    [m, ndig*ndig, r, c] int8 planes (index ndig*a + b)."""
    m, _, r, c = wp.shape
    b = np.ascontiguousarray(wp).view(np.int8).reshape(m, ndig, r, c, 4)
    return np.ascontiguousarray(
        b[..., :ndig].transpose(0, 1, 4, 2, 3).reshape(m, ndig * ndig, r, c))


def test_geometry_and_support_match():
    for limb, lg in itertools.product(("u16", "u32", "u64"), range(0, 16)):
        n = 1 << lg
        try:
            jr = nfl.Ring(limb, n, 1)
        except ValueError:
            continue
        tr = tnfl.Ring(limb, n, 1)
        assert tmxu.supports_fused(tr) == jmxu.supports_fused(jr), (limb, n)
        if n >= 8:
            assert tmxu._fused_geometry(n, limb) == jmxu._fused_geometry(n, limb)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("degree,agg,limb", TABLE_CONFIGS)
def test_fused_tables_byte_equal(degree, agg, limb, inverse):
    jr, tr = _both(degree, agg, limb)
    build = "_fused_inv_tables" if inverse else "_fused_tables"
    want = getattr(jmxu, build)(jr)
    got = getattr(tmxu, build)(tr)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("degree,agg,limb", TWIN_CONFIGS[:4])
def test_packed_tables_unpack_to_jax_planes(degree, agg, limb):
    """The kernel's int32 dp4a words hold exactly the JAX digit planes."""
    jr, _ = _both(degree, agg, limb)
    n1, n2, w1t, w2l = jmxu._fused_tables(jr)[:4]
    ndig = jmxu._fused_geometry(degree, limb)[3]
    t = interop.fused_tables_from_numpy(jmxu._fused_tables(jr), "cpu")
    assert t.ndig == ndig and (t.n1, t.n2) == (n1, n2)
    np.testing.assert_array_equal(
        unpack_planes(t.w2.numpy(), ndig), w2l)
    if ndig == 4:
        # un-interleave the JAX left operand: [m, a, r, (i1, b)] -> planes
        m = w1t.shape[0]
        planes = w1t.reshape(m, 4, n1, n1, 4).transpose(0, 1, 4, 2, 3) \
            .reshape(m, 16, n1, n1)
        np.testing.assert_array_equal(tmxu.pack_planes(planes, 4),
                                      t.w1.numpy())
        np.testing.assert_array_equal(unpack_planes(t.w1.numpy(), 4),
                                      planes)
    else:
        np.testing.assert_array_equal(
            unpack_planes(t.w1.numpy(), ndig), w1t)


@pytest.mark.parametrize("degree,agg,limb", TWIN_CONFIGS)
def test_twins_match_interpret_kernels(degree, agg, limb, rng):
    """Forward and inverse twins, on the port's own tables and on the JAX
    package's tables carried over by interop, against the Pallas kernels
    in interpret mode."""
    jr, tr = _both(degree, agg, limb)
    jctx, tctx = jr.context(), tr.context()
    x = rand_residues(jr, rng, batch=(2,))
    f = np.asarray(jmxu.ntt_pow_phi_fused(x, jctx, interpret=True))
    g = np.asarray(jmxu.invntt_pow_invphi_fused(f, jctx, interpret=True))
    jax_fwd = interop.fused_tables_from_numpy(jmxu._fused_tables(jr), "cpu")
    jax_inv = interop.fused_tables_from_numpy(jmxu._fused_inv_tables(jr),
                                              "cpu")
    for fwd_tabs, inv_tabs in ((None, None), (jax_fwd, jax_inv)):
        tf = tmxu.ntt_pow_phi_fused_plain(_t(x, jr), tctx, tables=fwd_tabs)
        np.testing.assert_array_equal(tf.numpy().view(jr.dtype), f)
        tg = tmxu.invntt_pow_invphi_fused_plain(_t(f, jr), tctx,
                                                tables=inv_tabs)
        np.testing.assert_array_equal(tg.numpy().view(jr.dtype), g)
    np.testing.assert_array_equal(g, x)
    # the public wrappers take the twin for a CPU tensor
    np.testing.assert_array_equal(
        tmxu.ntt_pow_phi_fused(_t(x, jr), tctx).numpy().view(jr.dtype), f)


def test_recombine_pack_boundary_exact():
    """The twin's carry-free Barrett pack at the extremes of the group-sum
    contract G_a in [-2^25, 2^25], against the oracle and the JAX
    _recombine_groups, as in tests/test_ntt_mxu.py."""
    ring = nfl.Ring("u32", 1 << 14, 4)
    gmax = 1 << 25
    combos = list(itertools.product([-gmax, 0, gmax], repeat=4))
    rand = np.random.default_rng(7).integers(-gmax, gmax + 1, size=(256, 4))
    allg = np.concatenate([np.array(combos, dtype=np.int64), rand], axis=0)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        m60 = (1 << 60) // p
        got = tmxu._recombine_plain(
            [torch.from_numpy(allg[:, a].copy()) for a in range(4)],
            torch.tensor(p), torch.tensor(m60), torch.tensor(0),
            lazy=False, ndig=4).numpy()
        want = np.asarray(jmxu._recombine_groups(
            [jnp.asarray(allg[:, a].astype(np.int32)).reshape(-1, 1, 1)
             for a in range(4)], jnp.uint32(p),
            lambda j, _m=m60: jnp.uint32(_m), 8, 4, corr=None,
            strict=True)).reshape(-1)
        np.testing.assert_array_equal(got, want)
        for i in range(allg.shape[0]):
            v = sum((int(allg[i, a]) + tmxu._BAL_BIAS) << (8 * a)
                    for a in range(4))
            assert int(got[i]) == v % p, (cm, i, allg[i])


@pytest.mark.parametrize("degree,agg,limb", [(1024, 60, "u32"),
                                             (128, 14, "u16")])
def test_strict_poison_on_broken_contract(degree, agg, limb, rng):
    """Tables that break a stage contract poison the whole block with
    0xFFFFFFFF (as the kernel does) only under strict mode, and the
    bracket turns the poison into an AssertionError."""
    jr, tr = _both(degree, agg, limb)
    ctx = tr.context()
    t = tmxu.fused_tables(tr, False, "cpu")
    # a twiddle that disagrees with its Shoup companion breaks the
    # twiddle's contract ([0, 2p) for u32, [0, p) for u16)
    broken = dataclasses.replace(t, tw=torch.full_like(t.tw, 0x7FFFFFFF))
    x = _t(rand_residues(jr, rng, batch=(2,)), jr)
    lax = tmxu.ntt_pow_phi_fused_plain(x, ctx, tables=broken)
    assert not bool((lax == -1).all())
    debug.set_strictmod(True)
    try:
        poisoned = tmxu.ntt_pow_phi_fused_plain(x, ctx, tables=broken)
        assert bool((poisoned == -1).all())
        from nfllib_tpu_torch.ops import ntt as tntt
        with pytest.raises(AssertionError):
            tntt._strict_bracket(
                lambda v: tmxu.ntt_pow_phi_fused_plain(v, ctx, tables=broken),
                x, ctx)
    finally:
        debug.set_strictmod(False)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor only the twin runs; the kernel wrapper itself
    refuses it instead of falling back."""
    from nfllib_tpu_torch import _kernels
    tr = tnfl.Ring("u32", 64, 2)
    t = tmxu.fused_tables(tr, False, "cpu")
    before = _kernels.NTT_FUSED_FWD.launches
    with pytest.raises(ValueError):
        _kernels.NTT_FUSED_FWD(torch.zeros(1, 2, 64, dtype=torch.int32), t,
                               False)
    assert _kernels.NTT_FUSED_FWD.launches == before
