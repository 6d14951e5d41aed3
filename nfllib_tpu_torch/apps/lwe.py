"""LWE-like symmetric encryption — the end-to-end acceptance workload.

PyTorch port of nfllib_tpu/apps/lwe.py, the reference demo's scheme exactly
(reference tests/nfllib_demo_main_op.cpp:26-58,260-331):

  keygen:  s ~ gaussian, NTT'd; sprime = compute_shoup(s)
           pka ~ uniform (already NTT domain); pkb ~ 2*gaussian, NTT'd;
           pkb += shoup(pka * s, sprime)
  encrypt: u ~ gaussian, e1,e2 ~ 2*gaussian, each NTT'd;
           resa = u*pka + e1 ; resb = u*pkb + e2
  decrypt: tmp = resb - resa*s ; inverse NTT;
           bit = coeff % 2 if coeff < p0/2 else 1 - coeff % 2

`encrypt` samples on the host stream (deterministic given key/nonce);
`encrypt_on_device` samples on the keys' device (prng/device_sampling.py:
the Gaussian kernels S3 and S4 on the card, which make their keystream
where they consume it), so a message costs no host transfer.  Keys,
ciphertexts and the compute graphs live on the caller's device, the card
unless it names another.
The graphs are plain functions: with NFL_TORCH_NTT=butterfly each is one
chain kernel (ops/ntt_pallas.py, ops/ntt_pallas_u64.py: K6/K8); otherwise
the NTTs dispatch as ops/ntt.py says and the pointwise ops are plain
torch.  Sums of decryptions of encryptions of zero must be exactly zero.

On a channel block of a ring (Ring.channel_block: a rank's share of the
mesh's rns axis) keygen, encrypt and encrypt_on_device give the whole
ring's rows of the block's channels: their samplers do (prng/sampling.py,
prng/device_sampling.py), and the graphs after them work channel by
channel.  A block's keys are the whole keys' rows.
"""
from __future__ import annotations

import dataclasses
import inspect

import torch

from .. import profiling
from ..ops import expr_program, modops, ntt
from ..poly import Poly, compute_shoup, shoup
from ..prng import device_sampling
from ..prng.gaussian import FastGaussianNoise
from ..prng.salsa20 import Salsa20Stream
from ..prng.sampling import gaussian, uniform
from ..ring import DEFAULT_DEVICE, Ring, canonical_device

SIGMA = 4.0  # demo parameters (nfllib_demo_main_op.cpp:8-9)


@dataclasses.dataclass
class LweKeys:
    s: Poly        # secret key, NTT domain
    sprime: Poly   # Shoup companion
    pka: Poly      # public key part a, NTT domain
    pkb: Poly      # public key part b, NTT domain


def make_gaussian_prng(security: int = 128, samples: int = 1 << 10,
                       sigma: float = SIGMA) -> FastGaussianNoise:
    return FastGaussianNoise(sigma, security, samples)


def keygen(ring: Ring, stream: Salsa20Stream, g_prng: FastGaussianNoise,
           device=DEFAULT_DEVICE) -> LweKeys:
    s = Poly.sample(ring, gaussian(g_prng), stream, device).ntt_pow_phi()
    sprime = compute_shoup(s)
    pka = Poly.sample(ring, uniform(), stream, device)
    pkb = Poly.sample(ring, gaussian(g_prng, 2), stream, device).ntt_pow_phi()
    pkb = (pkb + shoup(pka * s, sprime)).poly()
    return LweKeys(s=s, sprime=sprime, pka=pka, pkb=pkb)


def _fused_chain_module(ring, x):
    """The chain-kernel module for whole encrypt/decrypt graphs on the
    tensor `x`, or None for the plain graphs whose NTTs dispatch through
    ops/ntt.py; the counterpart of nfllib_tpu/apps/lwe.py:_fused_chain_module.
    There a fused transform kernel wins wherever it serves the ring, except
    under the butterfly mode; the fused modules serve every ring the chain
    kernels do, so here only NFL_TORCH_NTT=butterfly takes the chains."""
    return ntt._butterfly_module(ring, x) if ntt.kernel_mode() == "butterfly" \
        else None


def _encrypt_graph(ctx, pka, pkb, u, e1, e2):
    """Residue tensors in, residue tensors out: u/e1/e2 are coefficient-
    domain noise [..., m, n], the outputs the NTT-domain ciphertext
    halves."""
    with profiling.span("lwe_graph"):
        mod = _fused_chain_module(ctx.ring, u)
        if mod is not None:
            return mod.lwe_encrypt_fused(u, e1, e2, pka, pkb, ctx)
        un = ntt.ntt_pow_phi(u, ctx)
        e1n = ntt.ntt_pow_phi(e1, ctx)
        e2n = ntt.ntt_pow_phi(e2, ctx)
        resa = expr_program.apply("muladd", (e1n, un, pka), ctx.ring)
        resb = expr_program.apply("muladd", (e2n, un, pkb), ctx.ring)
        return resa, resb


# resb - resa * s mod p over the leaves (resb, resa, s): one pass
_DECRYPT_PROGRAM = expr_program.Program(
    3, (("mulmod", (1, 2)), ("submod", (0, 3))))


def _decrypt_graph(ctx, resa, resb, s, sprime):
    """The decrypted bits [..., m, n] (0 or 1, in the storage dtype); the
    p0/2 rule of the reference applies to every channel.  p0 is the limb's
    first prime, the whole ring's first modulus, on a channel block too
    (ring.py:Ring.channel_block), as every shard of the JAX graph reads
    the whole ring's ctx.p[0]."""
    with profiling.span("lwe_graph"):
        mod = _fused_chain_module(ctx.ring, resa)
        if mod is not None:
            tmp = mod.lwe_decrypt_fused(resa, resb, s, sprime, ctx)
        else:
            tmp = expr_program.run(_DECRYPT_PROGRAM, (resb, resa, s),
                                   ctx.ring)
            tmp = ntt.invntt_pow_invphi(tmp, ctx)
        v = modops.widen(tmp, modops.limb_bits(tmp.dtype))
        bit = v & 1
        return torch.where(v < int(ctx.ring.limb_params.P[0]) // 2, bit,
                           1 - bit).to(tmp.dtype)


def encrypt(keys: LweKeys, ring: Ring, stream: Salsa20Stream,
            g_prng: FastGaussianNoise):
    """One encryption of zero (reference encrypt(), demo_main_op.cpp:26-45),
    on the keys' device."""
    dev = keys.pka.device
    u = Poly.sample(ring, gaussian(g_prng), stream, dev)
    e1 = Poly.sample(ring, gaussian(g_prng, 2), stream, dev)
    e2 = Poly.sample(ring, gaussian(g_prng, 2), stream, dev)
    resa, resb = _encrypt_graph(ring.context(), keys.pka.data, keys.pkb.data,
                                u.data, e1.data, e2.data)
    return Poly(resa, ring), Poly(resb, ring)


def decrypt(keys: LweKeys, ring: Ring, resa: Poly, resb: Poly):
    """Decrypt to a per-(channel, coefficient) bit tensor (reference
    decrypt(), demo_main_op.cpp:48-58)."""
    return _decrypt_graph(ring.context(), resa.data, resb.data, keys.s.data,
                          keys.sprime.data)


def run_zero_sum_check(ring: Ring, repetitions: int = 10, key: bytes = None,
                       device=DEFAULT_DEVICE) -> bool:
    """The reference's correctness gate (demo_main_op.cpp:313-331): the sum of
    decryptions of encryptions of zero must be exactly zero."""
    stream = (Salsa20Stream(key) if key is not None
              else Salsa20Stream.from_system_entropy())
    g_prng = make_gaussian_prng()
    keys = keygen(ring, stream, g_prng, device)
    total = torch.zeros(ring.shape, dtype=torch.int64, device=device)
    for _ in range(repetitions):
        resa, resb = encrypt(keys, ring, stream, g_prng)
        total = total + decrypt(keys, ring, resa, resb).to(torch.int64)
    return bool(torch.all(total == 0))


# ---------------------------------------------------------------------------
# fully on-device pipeline: sampling feeds the encrypt graph on the device
# ---------------------------------------------------------------------------

def _encrypt_on_device_graph(ctx, g_prng, key: bytes, nonce, pka, pkb,
                             exact: bool = False, tables=None):
    """Noise sampling (the device Salsa20 Gaussian) and the encrypt graph
    on pka's device, with no host transfer and no host read.

    exact=False (default): the fixed-consumption device Gaussian, three
    nonces (u, e1, e2) starting at `nonce`, distribution-equal to the host
    encrypt(); on a CUDA device the three are one launch of S3.
    exact=True: the STREAM-EXACT device Gaussian with the nonces chained on
    the device (each sampler returns, as a device tensor, the nonce after
    the fill() calls the host walk would make, and the next starts there);
    the ciphertexts are bit-identical to host encrypt() with a stream at
    the same (key, nonce); on a CUDA device two launches of S4 a
    sampler.
    `nonce`: a Python int or a 0-d int64 tensor on the device; `tables`:
    device_sampling.gaussian_tables(g_prng, device, exact)."""
    ring, dev = ctx.ring, pka.device
    g1, g2 = gaussian(g_prng), gaussian(g_prng, 2)
    if exact:
        # each sampler returns (fills, nonce + fills) on the device; the
        # next one starts at the second
        u, f0 = device_sampling._gaussian_exact(ring, key, nonce, g1, dev,
                                                tables)
        e1, f1 = device_sampling._gaussian_exact(ring, key, f0[1], g2, dev,
                                                 tables)
        e2, _ = device_sampling._gaussian_exact(ring, key, f1[1], g2, dev,
                                                tables)
    else:
        u, e1, e2 = device_sampling.device_gaussians(
            ring, key, nonce, ((0, g1), (1, g2), (2, g2)), dev, tables)
    return _encrypt_graph(ctx, pka, pkb, u, e1, e2)


def encrypt_on_device(keys: LweKeys, ring: Ring, key: bytes, nonce,
                      g_prng: FastGaussianNoise, exact: bool = False):
    """Encrypt a zero with all randomness generated on the keys' device.

    exact=False: distribution-equal to encrypt() (fixed-consumption device
    Gaussian, nonces nonce .. nonce + 2).  exact=True: bit-identical to
    encrypt() for a host stream at the same (key, nonce), see
    _encrypt_on_device_graph.  `nonce` is a Python int or a 0-d int64
    tensor on the keys' device.  The sampler's device tables are built at
    the first call for a (sampler, ring, device) and cached, as jax.jit's
    cache holds them in the JAX package; later calls copy nothing between
    host and device."""
    tables = _ondevice_tables(ring, _gaussian_key(g_prng), keys.pka.device,
                              exact)
    resa, resb = _encrypt_on_device_graph(ring.context(), g_prng, key, nonce,
                                          keys.pka.data, keys.pkb.data,
                                          exact, tables)
    return Poly(resa, ring), Poly(resb, ring)


def _gaussian_key(g_prng: FastGaussianNoise) -> tuple:
    """Value key for the device-table cache: a FastGaussianNoise's behavior
    is fully determined by its constructor parameters, so caching on these
    is stable (unlike id(), which a collected-and-reallocated object could
    alias).  The key is derived from the constructor signature itself, so a
    parameter added to FastGaussianNoise can never alias distinct samplers
    here ('verbose' is behavior-neutral output and is excluded on
    purpose)."""
    params = [name for name in
              inspect.signature(FastGaussianNoise.__init__).parameters
              if name not in ("self", "verbose")]
    k = tuple(getattr(g_prng, name) for name in params)
    _GPRNG_BY_KEY.setdefault(k, g_prng)
    return k


_GPRNG_BY_KEY = {}
_TABLES = {}


def _ondevice_tables(ring: Ring, g_key: tuple, device, exact: bool):
    """The sampler's device tables (barrier words; with `exact` also
    lu_flag / lu_val and the compact slot / V2 / F2) for the sampler
    registered under g_key, with the ring's device tables (p_col) built
    too; cached per (g_key, ring, device, exact)."""
    device = canonical_device(device)
    k = (g_key, ring, device, exact)
    tabs = _TABLES.get(k)
    if tabs is None:
        ring.context().to(device)
        tabs = device_sampling.gaussian_tables(_GPRNG_BY_KEY[g_key], device,
                                               exact)
        _TABLES[k] = tabs
    return tabs


def register_gaussian(g_prng) -> tuple:
    """Kept for API compatibility with the JAX package; returns the stable
    value key."""
    return _gaussian_key(g_prng)
