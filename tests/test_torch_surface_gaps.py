"""The last public names the port lacked, against nfllib_tpu: Poly.degree /
nmoduli and the reflected operators, ops/modops.py repr_bits / eqmod /
neqmod, params.LimbParams.itemsize / limb_for_ctype, and the whole scalar
oracle (its modular ops on random ints of every limb, held also to the
port's torch ops; its ntt / inv_ntt / ntt_pow_phi / invntt_pow_invphi /
dft_eval at n <= 256, held also to the port's plain NTT).  Exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu import oracle as joracle
from nfllib_tpu import params as jparams
from nfllib_tpu.ops import modops as jmodops
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import oracle, params
from nfllib_tpu_torch.ops import modops, ntt as tntt
from nfllib_tpu_torch.utils import bitrev_indices

from conftest import make_ring, rand_residues

DEV = "cpu"
LIMBS = [("u16", 128, 28), ("u32", 256, 60), ("u64", 64, 124)]
NTT_RINGS = [("u16", 128, 14), ("u32", 8, 60), ("u32", 256, 60),
             ("u64", 64, 124), ("u64", 256, 62)]


def _rings(limb, degree, bits):
    return make_ring(degree, bits, limb), tnfl.ring_from_modulus(limb, degree,
                                                                 bits)


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_poly_degree_nmoduli_and_reflected_ops(limb, degree, bits, rng):
    jring, ring = _rings(limb, degree, bits)
    xa, xb = rand_residues(jring, rng, (2,)), rand_residues(jring, rng, (2,))
    ja, jb = nfl.Poly(xa, jring), nfl.Poly(xb, jring)
    ta = tnfl.Poly.from_numpy(ring, xa, DEV)
    tb = tnfl.Poly.from_numpy(ring, xb, DEV)
    assert (ta.degree, ta.nmoduli) == (ja.degree, ja.nmoduli) \
        == (degree, ring.nmoduli)
    assert tnfl.Poly.zeros(ring, device=DEV).degree == degree
    for op in ("__radd__", "__rsub__", "__rmul__"):
        got = getattr(ta, op)(tb)
        want = getattr(ja, op)(jb)
        assert isinstance(got, tnfl.Expr)
        np.testing.assert_array_equal(got.poly().numpy(),
                                      np.asarray(want.poly().data))
    for bad in (0, 3):
        with pytest.raises(TypeError):
            bad + ta
        with pytest.raises(TypeError):
            bad + ja


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_repr_bits_eqmod_neqmod(limb, degree, bits, rng):
    jring, ring = _rings(limb, degree, bits)
    want = jmodops.repr_bits(jnp.dtype(jring.dtype))
    assert modops.repr_bits(ring.torch_dtype) == want
    assert modops.repr_bits(ring.dtype) == want == ring.repr_bits
    with pytest.raises(TypeError):
        modops.repr_bits(torch.float32)
    with pytest.raises(TypeError):
        modops.repr_bits(np.int8)
    xa = rand_residues(jring, rng)
    xb = xa.copy()
    xb[:, ::3] = rand_residues(jring, rng)[:, ::3]
    ta = tnfl.Poly.from_numpy(ring, xa, DEV).data
    tb = tnfl.Poly.from_numpy(ring, xb, DEV).data
    for fn in ("eqmod", "neqmod"):
        got = getattr(modops, fn)(ta, tb)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jmodops, fn)(jnp.asarray(xa),
                                                          jnp.asarray(xb))))


@pytest.mark.parametrize("limb", ["u16", "u32", "u64"])
def test_limb_params_itemsize(limb):
    lp = params.get_limb_params(limb)
    assert lp.itemsize == jparams.get_limb_params(limb).itemsize
    assert lp.itemsize == np.dtype(lp.dtype).itemsize \
        == torch.tensor([], dtype=lp.torch_dtype).element_size()


@pytest.mark.parametrize("ctype", ["uint16_t", "uint32_t", "uint64_t",
                                   "int32_t"])
def test_limb_for_ctype(ctype):
    if ctype == "int32_t":
        for fn in (params.limb_for_ctype, jparams.limb_for_ctype):
            with pytest.raises(KeyError):
                fn(ctype)
        return
    assert params.limb_for_ctype(ctype) == jparams.limb_for_ctype(ctype)
    assert params.limb_for_ctype(ctype) in params.LIMBS


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_oracle_scalar_ops(limb, degree, bits, rng):
    """Each scalar op of the port's oracle equals the JAX package's, and
    the port's torch ops equal the oracle elementwise."""
    jring, ring = _rings(limb, degree, bits)
    w = ring.repr_bits
    rop, x, y = (rand_residues(jring, rng) for _ in range(3))
    tabs = ring.context().to(DEV)
    t = [tnfl.Poly.from_numpy(ring, a, DEV).data for a in (rop, x, y)]
    tshoup = modops.compute_shoup(t[2], tabs.p_col, tabs.shoup_f)
    torch_ops = {
        "addmod": modops.addmod(t[1], t[2], tabs.p_col),
        "submod": modops.submod(t[1], t[2], tabs.p_col),
        "mulmod": modops.mulmod(t[1], t[2], tabs.p_col, tabs.pn_col),
        "compute_shoup": tshoup,
        "mulmod_shoup": modops.mulmod_shoup(t[1], t[2], tshoup, tabs.p_col),
        "muladd": modops.muladd(t[0], t[1], t[2], tabs.p_col, tabs.pn_col),
        "muladd_shoup": modops.muladd_shoup(t[0], t[1], t[2], tshoup,
                                            tabs.p_col),
    }
    got = {k: v.numpy().view(ring.dtype) for k, v in torch_ops.items()}
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        for i in range(0, degree, 7):
            r, a, b = int(rop[cm, i]), int(x[cm, i]), int(y[cm, i])
            bp = oracle.compute_shoup(b, p, w)
            assert bp == joracle.compute_shoup(b, p, w)
            want = {
                "addmod": (oracle.addmod(a, b, p), joracle.addmod(a, b, p)),
                "submod": (oracle.submod(a, b, p), joracle.submod(a, b, p)),
                "mulmod": (oracle.mulmod(a, b, p), joracle.mulmod(a, b, p)),
                "compute_shoup": (bp, bp),
                "mulmod_shoup": (oracle.mulmod_shoup(a, b, bp, p, w),
                                 joracle.mulmod_shoup(a, b, bp, p, w)),
                "muladd": (oracle.muladd(r, a, b, p),
                           joracle.muladd(r, a, b, p)),
                "muladd_shoup": (oracle.muladd_shoup(r, a, b, bp, p, w),
                                 joracle.muladd_shoup(r, a, b, bp, p, w)),
            }
            for name, (o, jo) in want.items():
                assert o == jo == int(got[name][cm, i]), (name, cm, i)
            assert oracle.mulmod_shoup(a, b, bp, p, w) == a * b % p


@pytest.mark.parametrize("limb,degree,bits", NTT_RINGS)
def test_oracle_ntt(limb, degree, bits, rng):
    """ntt / inv_ntt / ntt_pow_phi / invntt_pow_invphi / dft_eval of the
    port's oracle on its own RingContext against the JAX oracle on the
    JAX package's, and against the port's plain transforms."""
    jring, ring = _rings(limb, degree, bits)
    ctx, jctx = ring.context(), jring.context()
    x = rand_residues(jring, rng)
    fwd = oracle.ntt_pow_phi(x, ctx)
    assert fwd.dtype == ring.dtype
    np.testing.assert_array_equal(fwd, joracle.ntt_pow_phi(x, jctx))
    np.testing.assert_array_equal(
        oracle.dft_eval(x, ctx)[:, bitrev_indices(degree)], fwd)
    np.testing.assert_array_equal(oracle.dft_eval(x, ctx),
                                  joracle.dft_eval(x, jctx))
    tx = tnfl.Poly.from_numpy(ring, x, DEV).data
    np.testing.assert_array_equal(
        tntt.ntt_pow_phi(tx, ctx).numpy().view(ring.dtype), fwd)
    back = oracle.invntt_pow_invphi(fwd, ctx)
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(back, joracle.invntt_pow_invphi(fwd, jctx))
    w, cm = ring.repr_bits, ring.nmoduli - 1
    p = int(ring.moduli[cm])
    row = oracle.ntt(x[cm], ctx.omegas[cm], ctx.shoupomegas[cm], p, w)
    assert row == joracle.ntt(x[cm], jctx.omegas[cm], jctx.shoupomegas[cm],
                              p, w)
    assert all(0 <= v < p for v in row)
    inv = oracle.inv_ntt(row, ctx.invomegas[cm], ctx.shoupinvomegas[cm], p, w)
    assert inv == joracle.inv_ntt(row, jctx.invomegas[cm],
                                  jctx.shoupinvomegas[cm], p, w)
    # the unscaled inverse: degree * x mod p
    assert inv == [degree * int(v) % p for v in x[cm]]
    np.testing.assert_array_equal(
        tntt.ntt(tx, ctx)[cm].numpy().view(ring.dtype), row)
