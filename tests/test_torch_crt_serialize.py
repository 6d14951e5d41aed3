"""The port's serialization, CRT lifting and the Poly surface that uses them,
against nfllib_tpu (byte-equal bytes, equal big integers)."""
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.crt import mpz2poly as jmpz2poly
from nfllib_tpu.crt import poly2mpz as jpoly2mpz
from nfllib_tpu.crt import set_mpz as jset_mpz
from nfllib_tpu.serialize import serialize_poly as jserialize
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import interop, oracle

from conftest import CONFIG_MATRIX, make_ring, rand_residues

DEV = "cpu"     # the port's constructors default to the card


def _pair(degree, agg, limb, rng, batch=()):
    jring = make_ring(degree, agg, limb)
    ring = tnfl.ring_from_modulus(limb, degree, agg)
    x = rand_residues(jring, rng, batch=batch)
    return (jring, ring, nfl.Poly(x, jring),
            interop.poly_from_numpy(x, ring, DEV))


@pytest.mark.parametrize("degree,agg,limb", CONFIG_MATRIX)
def test_serialize_equals_jax_and_roundtrips(degree, agg, limb, rng):
    jring, ring, jp, tp = _pair(min(degree, 256), agg, limb, rng, batch=(2,))
    buf = tnfl.serialize_poly(tp)
    assert buf == jserialize(jp) == tp.serialize_manually()
    it = np.dtype(ring.dtype).itemsize
    assert len(buf) == 2 * ring.nmoduli * ring.degree * it
    assert buf[:it] == int(tp.numpy()[0, 0, 0]).to_bytes(it, "little")
    back = tnfl.deserialize_poly(ring, buf, batch=(2,),
                                 device=DEV)
    assert back == tp and back.data.dtype == ring.torch_dtype


@pytest.mark.parametrize("degree,agg,limb", CONFIG_MATRIX + [(32, 496, "u64")])
def test_crt_lift_equals_jax(degree, agg, limb, rng):
    jring, ring, jp, tp = _pair(min(degree, 32), agg, limb, rng)
    lifted = tnfl.poly2mpz(tp)
    assert lifted == jpoly2mpz(jp) == tp.poly2mpz()
    assert all(0 <= v < ring.context().moduli_product for v in lifted)
    back = tnfl.mpz2poly(ring, lifted, DEV)
    assert back == tp
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jmpz2poly(jring, lifted).data))
    arr = tp.numpy()
    for cm in range(ring.nmoduli):
        pm = int(ring.moduli[cm])
        assert [v % pm for v in lifted] == arr[cm].tolist()


def test_crt_large_inputs_and_set_mpz(rng):
    """200-bit inputs reduce and lift consistently; set_mpz's
    broadcast-or-full semantics with negative values, as the JAX
    package's."""
    for limb, agg in (("u32", 240), ("u64", 248)):
        ring = tnfl.ring_from_modulus(limb, 16, agg)
        vals = [int.from_bytes(rng.bytes(25), "little") for _ in range(16)]
        p = tnfl.mpz2poly(ring, vals, DEV)
        assert tnfl.poly2mpz(p) == [v % ring.context().moduli_product
                                    for v in vals]
    for limb, agg in (("u32", 60), ("u64", 124)):
        ring = tnfl.ring_from_modulus(limb, 8, agg)
        jring = make_ring(8, agg, limb)
        for vals in ([-1, 5], list(range(-8, 8)),
                     [-(1 << 200) + k for k in range(8)]):
            got = tnfl.set_mpz(ring, vals, DEV).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(jset_mpz(jring, vals).data))
        assert int(tnfl.set_mpz(ring, [-1], DEV).numpy()[1, 0]) == \
            int(ring.moduli[1]) - 1
    with pytest.raises(ValueError):
        tnfl.mpz2poly(ring, [1, 2], DEV)
    with pytest.raises(ValueError):
        tnfl.poly2mpz(tnfl.Poly.zeros(ring, batch=(2,),
                                      device=DEV))


def test_poly_surface_u64(rng):
    """constant, get_modulus, p(cm, i), eqmod, muladd_shoup, the Expr
    rewrites and the product against the schoolbook oracle on a u64
    ring."""
    jring, ring, jp, a = _pair(32, 124, "u64", rng)
    b = interop.poly_from_numpy(rand_residues(jring, rng), ring, DEV)
    c = interop.poly_from_numpy(rand_residues(jring, rng), ring, DEV)
    one = tnfl.Poly.constant(ring, 1, device=DEV)
    assert one.numpy()[:, 0].tolist() == [1, 1]
    assert int(one.numpy().sum()) == 2
    assert tnfl.Poly.constant(ring, 0, device=DEV) == \
        tnfl.Poly.zeros(ring, device=DEV)
    big = tnfl.Poly.constant(ring, int(ring.moduli[0]) + 3,
                             device=DEV)
    assert big(0, 0) == 3 and big(1, 0) == (int(ring.moduli[0]) + 3) \
        % int(ring.moduli[1])
    assert a.get_modulus(1) == int(ring.moduli[1]) == jp.get_modulus(1)
    assert a(1, 5) == jp(1, 5)
    assert bool(a.eqmod(a).all()) and not bool(a.eqmod(b).all())
    bprec = tnfl.compute_shoup(b)
    jb = nfl.Poly(b.numpy(), jring)
    np.testing.assert_array_equal(
        c.muladd_shoup(a, b, bprec).numpy(),
        np.asarray(nfl.Poly(c.numpy(), jring).muladd_shoup(
            jp, jb, nfl.compute_shoup(jb)).data))
    assert tnfl.shoup(a * b, bprec) == a.mulmod(b)
    assert (a * b) + c == c.muladd(a, b)
    assert (a + b) - b == a
    prod = tnfl.shoup(a.ntt_pow_phi() * b.ntt_pow_phi(),
                      tnfl.compute_shoup(b.ntt_pow_phi())).invntt_pow_invphi()
    np.testing.assert_array_equal(
        prod.numpy(),
        oracle.negacyclic_mul_schoolbook(a.numpy(), b.numpy(), ring))
    assert prod.data.dtype == torch.int64
