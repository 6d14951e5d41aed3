"""The port's Poly surface and the quick-start product against nfllib_tpu
(byte-identical) and the schoolbook oracle."""
import numpy as np
import pytest
import torch

import nfllib_tpu as nfl
from nfllib_tpu.prng import Salsa20Stream as JStream
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import debug, interop, oracle
from nfllib_tpu_torch.prng import Salsa20Stream

from conftest import make_ring, rand_residues

DEV = "cpu"     # the port's constructors default to the card


def _quickstart(lib, stream, ring):
    kw = {"device": DEV} if lib is tnfl else {}
    a = lib.Poly.sample(ring, lib.uniform(), stream, **kw)
    b = lib.Poly.sample(ring, lib.uniform(), stream, **kw)
    fa, fb = a.ntt_pow_phi(), b.ntt_pow_phi()
    c = lib.shoup(fa * fb, lib.compute_shoup(fb)).invntt_pow_invphi()
    return a, b, fa, c


@pytest.mark.parametrize("degree,agg,limb", [(1024, 60, "u32"),
                                             (4096, 60, "u32"),
                                             (128, 28, "u16")])
def test_quickstart_product_byte_identical(degree, agg, limb):
    key = bytes(range(32))
    ja, jb, jfa, jc = _quickstart(nfl, JStream(key),
                                  nfl.ring_from_modulus(limb, degree, agg))
    ta, tb, tfa, tc = _quickstart(tnfl, Salsa20Stream(key),
                                  tnfl.ring_from_modulus(limb, degree, agg))
    for j, t in ((ja, ta), (jb, tb), (jfa, tfa), (jc, tc)):
        want = np.asarray(j.data)
        got = interop.poly_to_numpy(t)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_quickstart_product_equals_schoolbook():
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    a, b, _, c = _quickstart(tnfl, Salsa20Stream(bytes(range(1, 33))), ring)
    want = oracle.negacyclic_mul_schoolbook(a.numpy(), b.numpy(), ring)
    np.testing.assert_array_equal(c.numpy(), want)
    assert c == a.ntt_pow_phi().mulmod(b.ntt_pow_phi()).invntt_pow_invphi()


def test_operator_sugar_and_rewrites(rng):
    jring = make_ring(64, 60, "u32")
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    a, b, c = (interop.poly_from_numpy(rand_residues(jring, rng), ring, DEV)
               for _ in range(3))
    assert (a + b) - b == a
    assert tnfl.shoup(a * b, tnfl.compute_shoup(b)) == a.mulmod(b)
    assert (a * b) + c == c.muladd(a, b)
    assert c + (a * b) == c.muladd(a, b)
    assert (a * b) + c != a
    # evaluated once, one elementwise program (E1 on the card), then kept
    e = (a + b) * c
    assert e.poly() is e.poly()
    # long accumulation chains force deep operands instead of recursing
    acc = a
    for _ in range(100):
        acc = acc + b
    assert acc.depth <= tnfl.Expr._MAX_DEPTH + 1
    batch = interop.poly_from_numpy(rand_residues(jring, rng, batch=(3,)),
                                    ring, DEV)
    got = (batch + a).data
    for i in range(3):
        assert torch.equal(got[i], (tnfl.Poly(batch.data[i], ring) + a).data)
    with pytest.raises(TypeError):
        tnfl.shoup(a + b, b)
    other = tnfl.Poly.zeros(tnfl.ring_from_modulus("u32", 64, 30),
                            device=DEV)
    with pytest.raises(ValueError):
        a + other


def test_expression_matches_jax_chain(rng):
    """A mixed tree through both packages, byte-identical."""
    jring = make_ring(256, 28, "u16")
    ring = tnfl.ring_from_modulus("u16", 256, 28)
    xs = [rand_residues(jring, rng) for _ in range(4)]
    ja, jb, jc, jd = (nfl.Poly(x, jring) for x in xs)
    ta, tb, tc, td = (interop.poly_from_numpy(x, ring, DEV) for x in xs)
    want = ((ja * jb + jc) - jd * ja).poly()
    got = ((ta * tb + tc) - td * ta).poly()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.data))


def test_constructors_and_interop():
    ring = tnfl.ring_from_modulus("u16", 8, 28)
    p = tnfl.Poly.from_coeffs(ring, [1, 2, 3], device=DEV)
    assert p.numpy().tolist() == [[1, 2, 3, 0, 0, 0, 0, 0]] * 2
    big = int(ring.moduli[0]) + 5
    q = tnfl.Poly.from_coeffs(ring, [big], device=DEV)
    assert int(q.numpy()[0, 0]) == 5
    assert int(q.numpy()[1, 0]) == big % int(ring.moduli[1])
    with pytest.raises(ValueError):
        tnfl.Poly.from_coeffs(ring, list(range(9)), device=DEV)
    z = tnfl.Poly.zeros(ring, batch=(2,), device=DEV)
    assert z.data.shape == (2, 2, 8) and z.data.dtype == torch.int16
    assert z.batch_shape == (2,) and z.device.type == "cpu"
    u32 = tnfl.ring_from_modulus("u32", 8, 60)
    top = np.full((2, 8), 0xFFFFFFF0, dtype=np.uint32)
    t = interop.poly_from_numpy(top, u32, DEV)
    assert int(t.data[0, 0]) < 0                       # same bit pattern
    assert interop.poly_to_numpy(t).tobytes() == top.tobytes()
    with pytest.raises(TypeError):
        interop.poly_from_numpy(top.astype(np.uint16), u32, DEV)
    with pytest.raises(ValueError):
        tnfl.Poly.from_numpy(u32, top[:, :4], DEV)


def test_strict_mode_on_poly_ops(rng):
    ring = tnfl.ring_from_modulus("u32", 64, 60)
    jring = make_ring(64, 60, "u32")
    a = interop.poly_from_numpy(rand_residues(jring, rng), ring, DEV)
    bad_np = a.numpy().copy()
    bad_np[1, 5] = ring.moduli[1]
    bad = interop.poly_from_numpy(bad_np, ring, DEV)
    debug.set_strictmod(True)
    try:
        assert (a + a) == (a + a)
        for op in (lambda: bad.ntt_pow_phi(), lambda: a + bad,
                   lambda: a.mulmod(bad)):
            with pytest.raises(AssertionError):
                op()
    finally:
        debug.set_strictmod(False)


def test_readme_port_quickstart_runs():
    """The README's port snippets (u32, then u64) run as written (on the
    CPU here)."""
    import pathlib
    import re
    text = (pathlib.Path(__file__).resolve().parent.parent
            / "README.md").read_text()
    section = text[text.index("## PyTorch / H100 port"):]
    blocks = re.findall(r"```python\n(.*?)```", section, re.S)
    assert len(blocks) >= 2, "README.md lost the port's python blocks"
    ns: dict = {}
    exec(compile(blocks[0], "README.md:port", "exec"), ns)
    a, b, c = ns["a"], ns["b"], ns["c"]
    assert c.data.shape == (17, 16384) and c.data.dtype == torch.int32
    # the product equals the NTT-domain plain mulmod path
    want = a.ntt_pow_phi().mulmod(b.ntt_pow_phi()).invntt_pow_invphi()
    assert c == want
    exec(compile(blocks[1], "README.md:port-u64", "exec"), ns)
    a, b, c = ns["a"], ns["b"], ns["c"]
    assert c.data.shape == (8, 16384) and c.data.dtype == torch.int64
    want = a.ntt_pow_phi().mulmod(b.ntt_pow_phi()).invntt_pow_invphi()
    assert c == want
    assert ns["coeffs"] == tnfl.poly2mpz(c)
    assert tnfl.deserialize_poly(ns["ring"], ns["blob"], device=DEV) == c
