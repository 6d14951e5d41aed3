"""The plain reference against exact integer arithmetic at small sizes,
and against NFLlib's golden keystream and the port's samplers as second
witnesses."""
import json
import pathlib
import random

import pytest
import torch

from portbench import reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
U32 = json.loads((ROOT / "portbench/configs/he128_u32_n16384_q420.json")
                 .read_text())
U64 = json.loads((ROOT / "portbench/configs/he128_u64_n32768_q868.json")
                 .read_text())


def signed(v):
    return v - (1 << 64) if v >> 63 else v


def test_mulhi_is_the_high_word():
    rnd = random.Random(1)
    vals = [0, 1, (1 << 64) - 1, (1 << 63), (1 << 62) - 57] + \
        [rnd.getrandbits(64) for _ in range(300)]
    a = torch.tensor([signed(v) for v in vals])
    b = torch.tensor([signed(v) for v in reversed(vals)])
    got = reference.mulhi(a, b).tolist()
    want = [signed((x * y) >> 64) for x, y in zip(vals, reversed(vals))]
    assert got == want


@pytest.mark.parametrize("cfg", [U32, U64], ids=["u32", "u64"])
def test_modular_products_are_exact(cfg):
    primes = cfg["primes"][:3]
    mod = reference.Moduli(primes, "cpu")
    rnd = random.Random(2)
    rows = [[rnd.randrange(p) for _ in range(64)] + [0, 1, p - 1, p - 2]
            for p in primes]
    rows2 = [[rnd.randrange(p) for _ in range(64)] + [p - 1, p - 1, p - 1, 1]
             for p in primes]
    a, b = torch.tensor(rows), torch.tensor(rows2)
    assert mod.mul(a, b).tolist() == [[x * y % p for x, y in zip(r, s)]
                                      for r, s, p in zip(rows, rows2, primes)]
    assert mod.add(a, b).tolist() == [[(x + y) % p for x, y in zip(r, s)]
                                      for r, s, p in zip(rows, rows2, primes)]
    assert mod.sub(a, b).tolist() == [[(x - y) % p for x, y in zip(r, s)]
                                      for r, s, p in zip(rows, rows2, primes)]


def schoolbook(a, b, p):
    n = len(a)
    c = [0] * n
    for i in range(n):
        for j in range(n):
            if i + j < n:
                c[i + j] += a[i] * b[j]
            else:
                c[i + j - n] -= a[i] * b[j]
    return [v % p for v in c]


@pytest.mark.parametrize("n", [2, 8, 32])
@pytest.mark.parametrize("cfg", [U32, U64], ids=["u32", "u64"])
def test_ring_product_is_the_negacyclic_product(cfg, n):
    primes = cfg["primes"][:2]
    ntt = reference.NegacyclicNtt(primes, cfg["primitive_roots"][:2],
                                  cfg["max_poly_degree"], n, "cpu")
    rnd = random.Random(n)
    a = [[rnd.randrange(p) for _ in range(n)] for p in primes]
    b = [[rnd.randrange(p) for _ in range(n)] for p in primes]
    a[0][0] = b[1][-1] = primes[0] - 1
    got = ntt.product(torch.tensor(a), torch.tensor(b)).tolist()
    assert got == [schoolbook(x, y, p) for x, y, p in zip(a, b, primes)]
    assert ntt.inverse(ntt.forward(torch.tensor(a))).tolist() == a


@pytest.mark.parametrize("cfg", [U32, U64], ids=["u32", "u64"])
def test_forward_is_nfllib_evaluation_order(cfg):
    """forward(x)[k] = x(phi * omega^rev(k)), phi NFLlib's root of order
    2n: the order of NFLlib's ntt_pow_phi output."""
    n, p = 16, cfg["primes"][0]
    ntt = reference.NegacyclicNtt([p], cfg["primitive_roots"][:1],
                                  cfg["max_poly_degree"], n, "cpu")
    phi = cfg["primitive_roots"][0]
    for _ in range((cfg["max_poly_degree"] // n).bit_length() - 1):
        phi = phi * phi % p
    rnd = random.Random(3)
    x = [rnd.randrange(p) for _ in range(n)]
    rev = [int(format(k, "04b")[::-1], 2) for k in range(n)]
    want = [sum(c * pow(phi * pow(phi, 2 * rev[k], p) % p, j, p)
                for j, c in enumerate(x)) % p for k in range(n)]
    assert ntt.forward(torch.tensor([x])).tolist() == [want]


def test_salsa20_is_nfllib_golden_keystream():
    golden = (ROOT / "tools/golden/salsa20_golden.bin").read_bytes()[:1024]
    got = reference.salsa20_bytes(bytes(range(32)), torch.tensor([0]), 16)
    assert bytes(got[0].tolist()) == golden


def test_salsa20_matches_the_port_at_wrapping_nonces():
    from nfllib_tpu_torch.prng import salsa20
    key = bytes(range(7, 39))
    for nonce in (5, (1 << 64) - 1, 1 << 32):
        want = salsa20.keystream_plain(key, nonce, 3, 1, "cpu")
        got = reference.salsa20_bytes(
            key, torch.tensor([signed(nonce)]), 3)
        assert torch.equal(want.view(torch.uint8).reshape(1, -1), got)


def test_gaussian_barriers_and_draws_match_nfllib():
    """The barrier table NFLlib's MPFR sequence gives (the port replays it
    in libmpfr) and the fixed-consumption draw of the port's twin."""
    from nfllib_tpu_torch import gaussian, Ring
    from nfllib_tpu_torch.apps import lwe
    from nfllib_tpu_torch.prng import device_sampling as ds
    fg = lwe.make_gaussian_prng()
    g = reference.Gaussian(4.0, 128, 1024)
    assert g.barriers == [int(b) for b in fg.barriers]
    assert (g.wp, g.base) == (fg.word_precision, fg.base_value)
    ring = Ring("u32", 128, 2)
    key = bytes(range(32))
    out = ds.device_gaussians(ring, key, 11, ((0, gaussian(fg)),
                                              (1, gaussian(fg, 2))), "cpu")
    want = g.draw(key, torch.tensor([11, 12]), torch.tensor([1, 2]), 128)
    p = torch.tensor(ring.moduli).reshape(1, -1, 1)
    enc = torch.where(want[:, None] < 0, want[:, None] + p, want[:, None])
    assert torch.equal(out.to(torch.int64), enc)


def test_gaussian_count_by_leading_chunk_equals_count_barrier_by_barrier():
    g = reference.Gaussian(4.0, 128, 1024)
    rnd = random.Random(5)
    vals = [rnd.getrandbits(g.bit_precision) for _ in range(200)]
    for b in g.barriers[::7]:
        vals += [b - 1, b, b + 1, b ^ 1 << 10]
    vals = [v % (1 << g.bit_precision) for v in vals]
    words = torch.tensor([list(v.to_bytes(g.wp, "big")) for v in vals])
    rc = g.chunks(words)
    want = [sum(b <= v for b in g.barriers) for v in vals]
    assert g.count_all(rc).tolist() == want
    assert g.count(rc).tolist() == want
