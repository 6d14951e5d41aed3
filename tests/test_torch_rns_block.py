"""Channel blocks of a ring (the mesh's rns axis, nfllib_tpu_torch.ring.Ring
.channel_block) against the whole ring and the JAX package.

A block ring's tables are the whole ring's rows of its channels, built for
its own primes and cached under its own key; ops, Expr trees, the NTT in
every kernel mode and both LWE graphs on (batch, rns) blocks give the
blocks of the whole ring's results, and of the JAX package's results on a
("batch", "rns") virtual CPU mesh (tests/test_parallel.py:128-157).
Every sampler, keygen, encrypt and encrypt_on_device on a block give the
whole ring's rows of its channels (and JAX's rns-sharded encrypt_on_device
its shards); only the paths that read every channel refuse a block.
Integer arithmetic: exact equality throughout."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import nfllib_tpu as nfl
from nfllib_tpu.apps import lwe as jlwe
from nfllib_tpu.parallel import api as japi
from nfllib_tpu.prng import device_sampling as jdev
from nfllib_tpu.prng import sampling as jsamp
import nfllib_tpu_torch as tnfl
from nfllib_tpu_torch import crt, serialize
from nfllib_tpu_torch.apps import lwe as tlwe
from nfllib_tpu_torch.ops import dft_mxu, modops, ntt_mxu, ntt_pallas
from nfllib_tpu_torch.parallel import ntt_dist
from nfllib_tpu_torch.prng import Salsa20Stream
from nfllib_tpu_torch.prng import device_sampling as dsamp
from nfllib_tpu_torch.prng import sampling as samp

from conftest import rand_residues

DEV = "cpu"
# (limb, degree, modulus bits) of the whole ring, its channel blocks (an
# uneven split and an odd channel count among them) and its batch
RINGS = {"u16": (("u16", 256, 28), ((0, 1), (1, 2))),
         "u32": (("u32", 512, 120), ((0, 1), (1, 4))),
         "u64": (("u64", 256, 248), ((0, 3), (3, 4)))}
BATCH = 4
HALVES = (slice(0, 2), slice(2, 4))
# the LWE rings at a small degree, cut as the chip check cuts them
LWE_RINGS = {"u32": (("u32", 512, 510), ((0, 9), (9, 17))),
             "u64": (("u64", 256, 496), ((0, 4), (4, 8))),
             "u16": (("u16", 256, 28), ((0, 1), (1, 2)))}
LWE_BATCH = 4
CTX_ARRAYS = ("p", "pn", "p_col", "pn_col", "phis", "shoupphis",
              "invpoly_times_invphis", "shoupinvpoly_times_invphis",
              "omegas", "shoupomegas", "invomegas", "shoupinvomegas",
              "invpolyDegree", "omega_pows", "invomega_pows")
ROUTE_PROVIDERS = ("ntt64_e1_fwd", "ntt64_e2_fwd", "ntt64_e1_inv",
                   "ntt64_e2_inv")


def _t(arr, ring):
    arr = np.ascontiguousarray(np.asarray(arr, dtype=ring.dtype))
    return torch.from_numpy(arr.view(ring.limb_params.signed_dtype).copy())


def _np(t, ring):
    return t.numpy().view(ring.dtype)


def _jax_mesh(nmoduli=2):
    """(batch 2, rns 2) virtual mesh; rns 1 for an odd channel count, which
    JAX cannot split evenly (the u32 LWE ring's 17)"""
    r = 2 if nmoduli % 2 == 0 else 1
    return Mesh(np.array(jax.devices("cpu")[:2 * r]).reshape(2, r),
                ("batch", "rns"))


def _blocks(x, ring, blocks):
    """[(batch slice, channel slice, block Poly)] of a [B, m, n] array"""
    return [(bs, slice(c0, c1),
             tnfl.Poly(_t(x[bs, c0:c1], ring), ring.channel_block(c0, c1)))
            for bs in HALVES for c0, c1 in blocks]


def _assemble(parts, shape, ring):
    out = np.zeros(shape, dtype=ring.dtype)
    for bs, cs, t in parts:
        out[bs, cs] = _np(t, ring)
    return out


# ---------------------------------------------------------------------------
# the block ring and its tables
# ---------------------------------------------------------------------------

def test_whole_ring_keeps_its_equality_hash_and_repr():
    r = tnfl.Ring("u32", 512, 4)
    assert repr(r) == "Ring(limb='u32', degree=512, nmoduli=4)"
    assert hash(r) == hash(("u32", 512, 4))
    assert r == tnfl.Ring("u32", 512, 4, 0) and r.first == 0
    b = r.channel_block(1, 3)
    assert repr(b) == "Ring(limb='u32', degree=512, nmoduli=2, first=1)"
    assert b != tnfl.Ring("u32", 512, 2) and hash(b) != hash(("u32", 512, 2))
    assert b.moduli == r.moduli[1:3]
    assert r.channel_block(0, 2) == tnfl.Ring("u32", 512, 2)
    assert b.channel_block(1, 2) == r.channel_block(2, 3)


@pytest.mark.parametrize("make", [
    lambda: tnfl.Ring("u32", 512, 4).channel_block(-1, 2),
    lambda: tnfl.Ring("u32", 512, 4).channel_block(2, 2),
    lambda: tnfl.Ring("u32", 512, 4).channel_block(1, 5),
    lambda: tnfl.Ring("u16", 256, 1, 2),
    lambda: tnfl.Ring("u64", 256, 2, -1)])
def test_channel_block_validation(make):
    with pytest.raises(ValueError):
        make()


def _device_tables(ring):
    """every table the kernels and twins read, by name, on the CPU"""
    tabs = {f"ctx.{k}": v for k, v in vars(ring.context().to(DEV)).items()
            if isinstance(v, torch.Tensor) and k != "bitrev"}
    bt = ntt_pallas.kernel_tables(ring, DEV)
    tabs.update({f"bfly.{k}": getattr(bt, k)
                 for k in ("wp", "iwp", "twp", "itwp", "p", "pn", "bm")})
    for inv in (False, True):
        tw, tws = ntt_mxu._twiddle_device(ring, inv, torch.device(DEV))
        tabs[f"twiddle{inv:d}"], tabs[f"twiddle_s{inv:d}"] = tw, tws
    n1, n2 = ntt_mxu._geometry(ring.degree)
    for prov in ROUTE_PROVIDERS:
        size = n1 if "e1" in prov else n2
        for left in (False, True):
            dt = dft_mxu._device_tables(ring, prov, size, left,
                                        torch.device(DEV))
            for k in ("planes", "corr", "consts", "mma_planes"):
                tabs[f"{prov}.{left:d}.{k}"] = getattr(dt, k)
    rt = ntt_dist.rank_tables(ring, n1, 1, 0, DEV)
    for k in ("p_col", "col_w", "col_ws", "row_w", "row_ws"):
        tabs[f"dist.{k}"] = getattr(rt, k)
    for fam in ("fwd_plain", "fwd_twisted", "inv_plain", "inv_twisted"):
        for i, t in enumerate(getattr(rt, fam)):
            tabs[f"dist.{fam}{i}"] = t
    return tabs


@pytest.mark.parametrize("limb", sorted(RINGS))
def test_block_tables_are_the_whole_rows(limb):
    """Host context and every device table of each block (RingContext.to,
    K3/K7/K6/K8's ButterflyTables, the routes' twiddles, K9/K5's digit
    planes and constants, the four-step rank tables) equal the whole
    ring's rows of its channels and are contiguous."""
    spec, blocks = RINGS[limb]
    whole = tnfl.ring_from_modulus(*spec)
    wctx, wtabs = whole.context(), _device_tables(whole)
    for c0, c1 in blocks:
        ring = whole.channel_block(c0, c1)
        assert ring.moduli == whole.moduli[c0:c1] and ring.first == c0
        ctx = ring.context()
        for k in CTX_ARRAYS:
            np.testing.assert_array_equal(getattr(ctx, k),
                                          getattr(wctx, k)[c0:c1], k)
        assert ctx.phi_int == wctx.phi_int[c0:c1]
        assert ctx.omega_int == wctx.omega_int[c0:c1]
        for k, t in _device_tables(ring).items():
            assert t.is_contiguous(), k
            assert torch.equal(t, wtabs[k][c0:c1]), k


@pytest.mark.parametrize("limb", sorted(RINGS))
def test_block_caches_are_distinct(limb):
    """The tables of Ring(limb, n, k), built first, are not what a block
    [j:j + k] with j > 0 gets: every cache is keyed by the whole Ring."""
    spec, _ = RINGS[limb]
    whole = tnfl.ring_from_modulus(*spec)
    k = 1
    head = tnfl.Ring(whole.limb, whole.degree, k)
    htabs = _device_tables(head)
    block = whole.channel_block(whole.nmoduli - k, whole.nmoduli)
    assert block != head and block.moduli != head.moduli
    assert block.context() is not head.context()
    btabs = _device_tables(block)
    for name in ("ctx.p_col", "bfly.wp", "twiddle0", "ntt64_e1_fwd.0.consts",
                 "dist.col_w"):
        assert btabs[name] is not htabs[name]
        assert not torch.equal(btabs[name], htabs[name]), name
    assert int(btabs["ctx.p_col"][0, 0]) == whole.moduli[-1]


# ---------------------------------------------------------------------------
# ops, trees and transforms on (batch, rns) blocks
# ---------------------------------------------------------------------------

OPS = {
    "add": lambda a, b, m: (a + b).data,
    "mulmod": lambda a, b, m: a.mulmod(b).data,
    "shoup": lambda a, b, m: m.shoup(a * b, m.compute_shoup(b)).data,
    "tree": lambda a, b, m: ((a * b + a) * (b - a) + b * b).data,
    "ntt": lambda a, b, m: a.ntt_pow_phi().data,
    "intt": lambda a, b, m: a.invntt_pow_invphi().data,
}


@functools.lru_cache(maxsize=None)
def _op_inputs(limb):
    spec, _ = RINGS[limb]
    jr = nfl.ring_from_modulus(spec[0], spec[1], spec[2])
    rng = np.random.default_rng(20261018 + sorted(RINGS).index(limb))
    return (rand_residues(jr, rng, batch=(BATCH,)),
            rand_residues(jr, rng, batch=(BATCH,)))


@functools.lru_cache(maxsize=None)
def _jax_sharded(limb, op):
    """JAX's result on the ("batch", "rns") virtual mesh, as numpy"""
    spec, _ = RINGS[limb]
    jr = nfl.ring_from_modulus(spec[0], spec[1], spec[2])
    mesh = _jax_mesh()
    a, b = (japi.shard_poly(nfl.Poly(jnp.asarray(v), jr), mesh)
            for v in _op_inputs(limb))
    with mesh:
        return np.asarray(OPS[op](a, b, nfl))


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("limb", sorted(RINGS))
def test_ops_on_blocks(limb, op, monkeypatch):
    """The op on each (batch half, channel block) Poly, assembled, equals
    the whole ring's result and JAX's sharded one; the transforms in every
    kernel mode (the plain stage loop, the route's twin, the butterfly
    twin)."""
    spec, blocks = RINGS[limb]
    ring = tnfl.ring_from_modulus(*spec)
    x, y = _op_inputs(limb)
    want = _jax_sharded(limb, op)
    modes = ("plain", "auto", "butterfly") if "ntt" in op else ("auto",)
    for mode in modes:
        monkeypatch.setenv("NFL_TORCH_NTT", mode)
        whole = OPS[op](tnfl.Poly(_t(x, ring), ring),
                        tnfl.Poly(_t(y, ring), ring), tnfl)
        np.testing.assert_array_equal(_np(whole, ring), want)
        parts = [(bs, cs, OPS[op](pa, pb, tnfl)) for (bs, cs, pa), (_, _, pb)
                 in zip(_blocks(x, ring, blocks), _blocks(y, ring, blocks))]
        np.testing.assert_array_equal(_assemble(parts, x.shape, ring), want)


# ---------------------------------------------------------------------------
# the LWE graphs on blocks
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lwe_inputs(limb):
    """uniform keys (s and its Shoup companion), noise and ciphertexts of
    the whole ring, as numpy: decrypting uniform ciphertexts puts
    coefficients on both sides of every p/2"""
    spec, _ = LWE_RINGS[limb]
    jr = nfl.ring_from_modulus(spec[0], spec[1], spec[2])
    rng = np.random.default_rng(20261019 + spec[1])
    pka, pkb, s = (rand_residues(jr, rng) for _ in range(3))
    sprime = np.asarray(nfl.Poly(jnp.asarray(s), jr).compute_shoup().data)
    u, e1, e2, resa, resb = (rand_residues(jr, rng, batch=(LWE_BATCH,))
                             for _ in range(5))
    return dict(pka=pka, pkb=pkb, s=s, sprime=sprime, u=u, e1=e1, e2=e2,
                resa=resa, resb=resb)


@functools.lru_cache(maxsize=None)
def _jax_lwe(limb):
    """JAX's encrypt and decrypt graphs of the whole ring, jitted over the
    ("batch", "rns") virtual mesh as __graft_entry__.py runs them"""
    spec, _ = LWE_RINGS[limb]
    jr = nfl.ring_from_modulus(spec[0], spec[1], spec[2])
    ctx = jr.context()
    v = _lwe_inputs(limb)
    mesh = _jax_mesh(jr.nmoduli)
    sh_b = NamedSharding(mesh, P("batch", "rns", None))
    sh_k = NamedSharding(mesh, P("rns", None))
    enc = jax.jit(functools.partial(jlwe._encrypt_graph, ctx),
                  in_shardings=(sh_k, sh_k, sh_b, sh_b, sh_b))
    dec = jax.jit(functools.partial(jlwe._decrypt_graph, ctx),
                  in_shardings=(sh_b, sh_b, sh_k, sh_k))
    with mesh:
        ra, rb = enc(*(jnp.asarray(v[k]) for k in ("pka", "pkb", "u", "e1",
                                                  "e2")))
        bits = dec(*(jnp.asarray(v[k]) for k in ("resa", "resb", "s",
                                                "sprime")))
    return np.asarray(ra), np.asarray(rb), np.asarray(bits)


@pytest.mark.parametrize("mode", ["auto", "butterfly"])
@pytest.mark.parametrize("limb", sorted(LWE_RINGS))
def test_lwe_graphs_on_blocks(limb, mode, monkeypatch):
    """_encrypt_graph and _decrypt_graph on each (batch half, channel
    block) equal the whole ring's blocks and JAX's sharded graphs; the
    decrypt of uniform random ciphertexts reads the whole ring's first
    modulus on every block (a block's own first modulus gives other bits
    on the u16/u32 blocks, so the case sees that mistake)."""
    monkeypatch.setenv("NFL_TORCH_NTT", mode)
    spec, blocks = LWE_RINGS[limb]
    ring = tnfl.ring_from_modulus(*spec)
    v = _lwe_inputs(limb)
    ra, rb, bits = _jax_lwe(limb)
    ctx = ring.context()
    wa, wb = tlwe._encrypt_graph(ctx, *(_t(v[k], ring) for k in (
        "pka", "pkb", "u", "e1", "e2")))
    wbits = tlwe._decrypt_graph(ctx, *(_t(v[k], ring) for k in (
        "resa", "resb", "s", "sprime")))
    for got, want in ((wa, ra), (wb, rb), (wbits, bits)):
        np.testing.assert_array_equal(_np(got, ring), want)
    ea, eb, dec, own_p0 = [], [], [], []
    for bs in HALVES:
        for c0, c1 in blocks:
            cs = slice(c0, c1)
            bring = ring.channel_block(c0, c1)
            bctx = bring.context()
            k = {n: _t(v[n][cs], ring) for n in ("pka", "pkb", "s",
                                                 "sprime")}
            x = {n: _t(v[n][bs, cs], ring) for n in ("u", "e1", "e2",
                                                     "resa", "resb")}
            a, b = tlwe._encrypt_graph(bctx, k["pka"], k["pkb"], x["u"],
                                       x["e1"], x["e2"])
            ea.append((bs, cs, a))
            eb.append((bs, cs, b))
            dec.append((bs, cs, tlwe._decrypt_graph(
                bctx, x["resa"], x["resb"], k["s"], k["sprime"])))
            own_p0.append(bring.moduli[0])
    shape = v["u"].shape
    np.testing.assert_array_equal(_assemble(ea, shape, ring), ra)
    np.testing.assert_array_equal(_assemble(eb, shape, ring), rb)
    np.testing.assert_array_equal(_assemble(dec, shape, ring), bits)
    if limb != "u64":
        # some coefficients before the p0/2 rule lie between the whole
        # ring's p0/2 and a block's own first modulus over 2
        tmp = ntt_pallas.lwe_decrypt_plain(*(_t(v[k], ring) for k in (
            "resa", "resb", "s", "sprime")), ctx)
        vals = modops.widen(tmp, ring.repr_bits)
        p0 = ring.moduli[0]
        assert any(bool(((vals >= min(p0, q) // 2)
                         & (vals < max(p0, q) // 2)).any())
                   for q in own_p0 if q != p0)


# ---------------------------------------------------------------------------
# samplers, keygen and encryption on a block: the whole ring's rows
# ---------------------------------------------------------------------------

_G = tlwe.make_gaussian_prng(samples=256)
_KEY = b"\x0b" * 32
_NONCE = 7
# the whole ring (limb, degree, modulus bits) and a block with first > 0:
# at u16 n = 8 and u32 n = 8 the uniform's first limb lies off the 64-byte
# keystream block grid (16 and 96 bytes in), at u64 n = 64 on it
SAMPLER_BLOCKS = {"u16 n=8 [1:2]": (("u16", 8, 28), (1, 2)),
                  "u32 n=8 [3:5]": (("u32", 8, 150), (3, 5)),
                  "u64 n=64 [1:3]": (("u64", 64, 248), (1, 3))}


@functools.lru_cache(maxsize=None)
def _jax_gaussian():
    return jlwe.make_gaussian_prng(samples=256)


def _stream(native=True):
    s = Salsa20Stream(_KEY, _NONCE)
    if not native:
        s._native = None
    return s


def _h(ring):
    return max(1, ring.degree // 4)


def _host(draw, native=True):
    """a host draw from a stream at (_KEY, _NONCE): (outputs, its nonce
    after)"""
    def run(ring):
        s = _stream(native)
        return [draw(ring, s)], s.nonce
    return run


def _on_device(mode):
    return lambda r: ([tnfl.Poly.sample_on_device(r, mode(r), _KEY, _NONCE,
                                                  DEV)], None)


def _with_advance(fn):
    def run(r):
        out, adv = fn(r)
        return [out], int(adv)
    return run


@functools.lru_cache(maxsize=None)
def _whole_keys(limb, degree):
    bits = next(spec[2] for spec, _ in SAMPLER_BLOCKS.values()
                if spec[0] == limb)
    return tlwe.keygen(tnfl.ring_from_modulus(limb, degree, bits), _stream(),
                       _G, DEV)


def _keys(ring):
    """the whole ring's keys (keygen from _stream()), the rows of `ring`'s
    channels"""
    k = _whole_keys(ring.limb, ring.degree)
    rows = slice(ring.first, ring.first + ring.nmoduli)
    return tlwe.LweKeys(*(tnfl.Poly(getattr(k, n).data[rows].contiguous(),
                                    ring)
                          for n in ("s", "sprime", "pka", "pkb")))


def _lwe(fn):
    def run(r):
        s = _stream()
        out = fn(r, s)
        return list(vars(out).values()) if isinstance(out, tlwe.LweKeys) \
            else list(out), s.nonce
    return run


DRAWS = {
    "Poly.sample": _host(lambda r, s: tnfl.Poly.sample(r, tnfl.uniform(), s,
                                                        DEV)),
    "sample_uniform": _host(samp.sample_uniform, native=False),
    "sample_non_uniform": _host(lambda r, s: samp.sample_non_uniform(
        r, s, tnfl.non_uniform(5, 3))),
    "sample_zo": _host(lambda r, s: samp.sample_zo(r, s, tnfl.ZO_dist(127))),
    "sample_hwt": _host(lambda r, s: samp.sample_hwt(r, s,
                                                     tnfl.hwt_dist(_h(r)))),
    "sample_gaussian": _host(lambda r, s: samp.sample_gaussian(
        r, s, tnfl.gaussian(_G, 2))),
    "sample_on_device.uniform": _on_device(lambda r: tnfl.uniform()),
    "sample_on_device.non_uniform": _on_device(
        lambda r: tnfl.non_uniform(5, 3)),
    "sample_on_device.ZO": _on_device(lambda r: tnfl.ZO_dist(127)),
    "sample_on_device.hwt": _on_device(lambda r: tnfl.hwt_dist(_h(r))),
    "sample_on_device.gaussian": _on_device(lambda r: tnfl.gaussian(_G)),
    "device_gaussian_exact": _with_advance(
        lambda r: dsamp.device_gaussian_exact(
            r, _KEY, _NONCE, tnfl.gaussian(_G, 2), return_fills=True,
            device=DEV)),
    "device_hwt_exact": _with_advance(lambda r: dsamp.device_hwt_exact(
        r, _KEY, _NONCE, tnfl.hwt_dist(_h(r)), return_fills=True,
        device=DEV)),
    "keygen": _lwe(lambda r, s: tlwe.keygen(r, s, _G, DEV)),
    "encrypt": _lwe(lambda r, s: tlwe.encrypt(_keys(r), r, s, _G)),
    "encrypt_on_device": _lwe(lambda r, s: tlwe.encrypt_on_device(
        _keys(r), r, _KEY, _NONCE, _G)),
    "encrypt_on_device.exact": _lwe(lambda r, s: tlwe.encrypt_on_device(
        _keys(r), r, _KEY, _NONCE, _G, exact=True)),
}
# the JAX package's draw on the whole ring: (residues, advance or None)
JAX_DRAWS = {
    "sample_on_device.uniform": lambda jr, g: (jdev.device_uniform(
        jr, _KEY, _NONCE), None),
    "sample_on_device.non_uniform": lambda jr, g: (jdev.device_non_uniform(
        jr, _KEY, _NONCE, jsamp.non_uniform(5, 3)), None),
    "sample_on_device.ZO": lambda jr, g: (jdev.device_zo(
        jr, _KEY, _NONCE, jsamp.ZO_dist(127)), None),
    "sample_on_device.hwt": lambda jr, g: (jdev.device_hwt(
        jr, _KEY, _NONCE, jsamp.hwt_dist(_h(jr))), None),
    "sample_on_device.gaussian": lambda jr, g: (jdev.device_gaussian(
        jr, _KEY, _NONCE, jsamp.gaussian(g)), None),
    "device_gaussian_exact": lambda jr, g: jdev.device_gaussian_exact(
        jr, _KEY, _NONCE, jsamp.gaussian(g, 2), return_fills=True),
    "device_hwt_exact": lambda jr, g: jdev.device_hwt_exact(
        jr, _KEY, _NONCE, jsamp.hwt_dist(_h(jr)), return_fills=True),
}


def _unsigned(x, ring):
    if isinstance(x, tnfl.Poly):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy().view(ring.dtype)
    return np.asarray(x)


@pytest.mark.parametrize("block", sorted(SAMPLER_BLOCKS))
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_block_draw_is_the_whole_rows(name, block, monkeypatch):
    """Every sampler entry point, keygen, encrypt and encrypt_on_device
    (fixed and exact) on a channel block with first > 0 give the rows
    first .. first + m - 1 of the same call on the whole ring, and leave
    the stream at the whole draw's nonce (the exact samplers: the same
    advance); the device samplers' whole draws equal the JAX package's,
    so each block is its draw's rows.  The LWE paths run in both kernel
    modes (the route's and the chain kernels' twins).  The stream-exact
    Gaussian draws at the block's degree too, below its fill size at n =
    8 (fills of 9 words, under the 18 words of a full-precision sample)."""
    spec, (c0, c1) = SAMPLER_BLOCKS[block]
    whole = tnfl.ring_from_modulus(*spec)
    ring = whole.channel_block(c0, c1)
    lwe_path = name.startswith(("keygen", "encrypt"))
    for mode in ("auto", "butterfly") if lwe_path else ("auto",):
        monkeypatch.setenv("NFL_TORCH_NTT", mode)
        w_out, w_state = DRAWS[name](whole)
        b_out, b_state = DRAWS[name](ring)
        assert len(b_out) == len(w_out) and b_state == w_state
        for w, b in zip(w_out, b_out):
            b = _unsigned(b, ring)
            assert b.shape[-2:] == ring.shape
            np.testing.assert_array_equal(b, _unsigned(w, whole)[..., c0:c1,
                                                                 :])
    if name in JAX_DRAWS:
        jout, jadv = JAX_DRAWS[name](nfl.ring_from_modulus(*spec),
                                     _jax_gaussian())
        np.testing.assert_array_equal(_unsigned(b_out[0], ring),
                                      np.asarray(jout)[c0:c1])
        assert b_state == (None if jadv is None else int(jadv))


def test_jax_rns_sharded_encrypt_on_device_is_the_blocks():
    """The JAX package's encrypt_on_device (the fixed Gaussian) on keys
    placed P("rns", None) on a (batch 2, rns 2) virtual mesh returns
    ciphertexts sharded over rns; each device's shard equals the port's
    encrypt_on_device on that channel block, the keys carried across as
    numpy."""
    ring = tnfl.Ring("u32", 256, 4)
    jr = nfl.Ring("u32", 256, 4)
    keys = tlwe.keygen(ring, _stream(), _G, DEV)
    mesh = _jax_mesh()
    sh = NamedSharding(mesh, P("rns", None))
    jkeys = jlwe.LweKeys(*(nfl.Poly(jax.device_put(
        jnp.asarray(getattr(keys, n).numpy()), sh), jr)
        for n in ("s", "sprime", "pka", "pkb")))
    with mesh:
        ja, jb = jlwe.encrypt_on_device(jkeys, jr, _KEY, _NONCE,
                                        _jax_gaussian())
    assert len(ja.data.addressable_shards) == 4
    seen = set()
    for jc, half in ((ja, 0), (jb, 1)):
        for shard in jc.data.addressable_shards:
            rows = shard.index[0]
            c0, c1 = rows.start or 0, rows.stop or ring.nmoduli
            assert (c0, c1) != (0, ring.nmoduli)
            block = ring.channel_block(c0, c1)
            bkeys = tlwe.LweKeys(*(tnfl.Poly(
                getattr(keys, n).data[c0:c1].contiguous(), block)
                for n in ("s", "sprime", "pka", "pkb")))
            got = tlwe.encrypt_on_device(bkeys, block, _KEY, _NONCE, _G)
            np.testing.assert_array_equal(got[half].numpy(),
                                          np.asarray(shard.data))
            seen.add((c0, c1))
    assert seen == {(0, 2), (2, 4)}


# ---------------------------------------------------------------------------
# what a block refuses
# ---------------------------------------------------------------------------

_BLOCK = tnfl.Ring("u32", 256, 2, 1)


REFUSALS = {
    "poly2mpz": lambda r: crt.poly2mpz(tnfl.Poly.zeros(r, device=DEV)),
    "Poly.poly2mpz": lambda r: tnfl.Poly.zeros(r, device=DEV).poly2mpz(),
    "serialize_poly": lambda r: serialize.serialize_poly(
        tnfl.Poly.zeros(r, device=DEV)),
    "Poly.serialize_manually": lambda r: tnfl.Poly.zeros(
        r, device=DEV).serialize_manually(),
    "deserialize_poly": lambda r: serialize.deserialize_poly(
        r, bytes(4 * r.nmoduli * r.degree), device=DEV),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_block_refuses(name):
    """The CRT lift and the reference's byte format need every channel: on
    a block ring each raises NotImplementedError, and on the ring of the
    same first primes it runs."""
    with pytest.raises(NotImplementedError, match="channel block"):
        REFUSALS[name](_BLOCK)
    REFUSALS[name](tnfl.Ring(_BLOCK.limb, _BLOCK.degree, _BLOCK.nmoduli))


@pytest.mark.parametrize("shape", [(4, 2, 512), (3, 512), (512,),
                                   (4, 512, 4)])
def test_poly_refuses_data_of_another_shape(shape):
    """Poly and Poly.from_numpy hold data whose last two dims are the
    ring's shape; a block's data with the whole ring (or the reverse) is
    refused where it is made, not at its first op."""
    ring = tnfl.Ring("u32", 512, 4)
    with pytest.raises(ValueError, match="residues"):
        tnfl.Poly(torch.zeros(shape, dtype=torch.int32), ring)
    with pytest.raises(ValueError, match="residues"):
        tnfl.Poly.from_numpy(ring, np.zeros(shape, dtype=np.uint32), DEV)
    tnfl.Poly(torch.zeros((3,) + ring.shape, dtype=torch.int32), ring)
