"""The rest of the port's Poly / Expr surface against nfllib_tpu: truth
value, iteration order, NFLlib's initializer-list str for every limb
suffix, the residue accessor on an expression, the free functions add /
sub / mul and the aliases PolyP, MulExpr, poly_from_modulus and
poly_p_from_modulus (exact)."""
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
import nfllib_tpu.poly as jpoly
import nfllib_tpu_torch as tnfl
import nfllib_tpu_torch.poly as tpoly
from nfllib_tpu_torch import interop

from conftest import make_ring, rand_residues

DEV = "cpu"     # the port's constructors default to the card
LIMBS = [("u16", 8, 28), ("u32", 8, 60), ("u64", 8, 124)]


def _pair(limb, degree, bits, rng):
    jring = make_ring(degree, bits, limb)
    ring = tnfl.ring_from_modulus(limb, degree, bits)
    x = rand_residues(jring, rng)
    return (nfl.Poly(x, jring), interop.poly_from_numpy(x, ring, DEV), jring,
            ring)


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_bool_of_poly_and_expr(limb, degree, bits, rng):
    ja, ta, jring, ring = _pair(limb, degree, bits, rng)
    assert bool(tnfl.Poly.zeros(ring, device=DEV)) is False
    assert bool(nfl.Poly.zeros(jring)) is False
    assert bool(ta) is True and bool(ja) is True
    assert bool(ta - ta) is False and bool(ja - ja) is False
    assert bool(ta + ta) is bool(ja + ja) is True
    one = tnfl.Poly.from_coeffs(ring, [0] * (degree - 1) + [1], device=DEV)
    assert bool(one) is True
    assert bool(tnfl.Poly.zeros(ring, batch=(2,), device=DEV)) is False


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_iter_and_str_match_jax(limb, degree, bits, rng):
    """Storage order (moduli-major), unsigned values, and the suffix after
    each value's predecessor: U for u16, UL for u32, ULL for u64."""
    ja, ta, _, _ = _pair(limb, degree, bits, rng)
    assert list(ta) == list(ja)
    assert list(ta) == np.asarray(ja.data).reshape(-1).tolist()
    assert str(ta) == str(ja)
    suffix = {"u16": "U", "u32": "UL", "u64": "ULL"}[limb]
    assert str(ta).startswith("{ ") and str(ta).endswith(f"{suffix} }}")
    assert str(ta).count(f"{suffix}, ") == len(list(ta)) - 1
    e, je = ta * ta + ta, ja * ja + ja
    assert list(e) == list(je) and str(e) == str(je)
    x, p = ta(1, 3), ta.get_modulus(1)
    assert e(1, 3) == je(1, 3) == (x * x + x) % p


def test_str_of_a_known_poly():
    ring = tnfl.ring_from_modulus("u32", 4, 30)
    p = tnfl.Poly.from_coeffs(ring, [1, 2, 3, 4], device=DEV)
    assert str(p) == "{ 1UL, 2UL, 3UL, 4UL }"
    jp = nfl.Poly.from_coeffs(make_ring(4, 30, "u32"), [1, 2, 3, 4])
    assert str(p) == str(jp)


def test_expr_getattr_still_refuses_dunders(rng):
    _, ta, _, _ = _pair("u32", 8, 60, rng)
    e = ta + ta
    with pytest.raises(AttributeError):
        e.__array_interface__
    assert e._val is None              # nothing forced by the probe
    assert list(e) == list((ta + ta).poly())
    assert e._val is not None          # iteration forced it


@pytest.mark.parametrize("limb,degree,bits", LIMBS)
def test_free_functions_match_jax(limb, degree, bits, rng):
    ja, ta, jring, ring = _pair(limb, degree, bits, rng)
    y = rand_residues(jring, rng)
    jb, tb = nfl.Poly(y, jring), interop.poly_from_numpy(y, ring, DEV)
    for jfn, tfn in ((nfl.add, tnfl.add), (nfl.sub, tnfl.sub),
                     (nfl.mul, tnfl.mul)):
        got, want = tfn(ta, tb), jfn(ja, jb)
        assert isinstance(got, tnfl.Poly if tfn is tnfl.mul else tnfl.Expr)
        np.testing.assert_array_equal(tpoly._as_poly(got).numpy(),
                                      np.asarray(jpoly._as_poly(want).data))
    # an expression operand is forced first, as in the reference
    got = tnfl.mul(ta + tb, tb)
    assert torch.equal(got.data, ((ta + tb) * tb).data)


def test_aliases():
    assert tnfl.PolyP is tnfl.Poly and tpoly.PolyP is tnfl.Poly
    assert tpoly.MulExpr is tnfl.Expr
    assert tnfl.poly_from_modulus is tnfl.ring_from_modulus
    assert tnfl.poly_p_from_modulus is tnfl.ring_from_modulus
    for name in ("PolyP", "add", "sub", "mul", "poly_from_modulus",
                 "poly_p_from_modulus"):
        assert name in tnfl.__all__ and name in nfl.__all__
    for name in ("PolyP", "MulExpr"):
        assert name in tpoly.__all__ and name in jpoly.__all__
    ring = tnfl.poly_p_from_modulus("u16", 16, 28)
    jring = nfl.poly_p_from_modulus("u16", 16, 28)
    assert [int(p) for p in ring.moduli] == [int(p) for p in jring.moduli]
    assert isinstance(tnfl.PolyP.zeros(ring, device=DEV), tnfl.Poly)
