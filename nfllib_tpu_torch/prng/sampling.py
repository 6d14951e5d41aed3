"""Random polynomial samplers (reference include/nfl/core.hpp:145-391).

Port of the host (numpy) tier of nfllib_tpu/prng/sampling.py: every sampler
consumes a Salsa20Stream exactly like the reference's fastrandombytes-driven
samplers — same number of calls, same byte interpretation, same masking
quirks — so residue arrays are byte-identical to the reference's for the
same (key, nonce).  The uniform sampler takes the native one-call branch
(csrc/nfl_native.cpp nfl_uniform_*) when the stream carries the native
tier, as the JAX package's does; the device tier is
prng/device_sampling.py.

Sampler catalogue and their reference quirks, all preserved:
  * uniform: one stream call of m*n*itemsize bytes; per channel mask to the
    modulus bit width then a single conditional subtract — NOT rejection
    sampling (documented bias tradeoff, reference core.hpp:158-177).
  * non_uniform(ub, amp): one call of n*itemsize bytes; centered noise
    replicated to every channel, negatives encoded p + v (core.hpp:194-282).
  * ZO_dist(rho): one call of n bytes; value (p-1) + (byte & 2), i.e. -1 maps
    to p-1 and +1 maps to p+1 — the reference stores the *non-canonical* p+1
    (core.hpp:333-344); we reproduce it bit-for-bit.
  * hwt_dist(h): reservoir sampling over 8-byte words with rejection,
    refilling h words at a time; sign words drawn once and reused across
    channels; same (p-1) + (word & 2) encoding (core.hpp:351-391).
  * gaussian: see gaussian.py (FastGaussianNoise equivalent).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ring import Ring
from .salsa20 import Salsa20Stream


# ---------------------------------------------------------------------------
# sampler mode tags (reference poly.hpp:42-67)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class uniform:
    pass


@dataclasses.dataclass(frozen=True)
class non_uniform:
    upper_bound: int
    amplifier: int = 1


@dataclasses.dataclass(frozen=True)
class ZO_dist:
    rho: int = 0x7F  # P(-1)=P(+1)=(rho/0xFF)/2


@dataclasses.dataclass(frozen=True)
class hwt_dist:
    hwt: int


@dataclasses.dataclass(frozen=True)
class gaussian:
    fg_prng: object          # FastGaussianNoise instance
    amplifier: int = 1

    def __hash__(self):
        return hash((id(self.fg_prng), self.amplifier))


# ---------------------------------------------------------------------------
# host samplers (numpy, byte-exact vs the reference)
# ---------------------------------------------------------------------------

def sample_uniform(ring: Ring, stream: Salsa20Stream) -> np.ndarray:
    lp = ring.limb_params
    if getattr(stream, "_native", None) is not None:
        # native one-call path (csrc nfl_uniform_*): same stream consumption
        # and mask-subtract semantics, nonce bumped exactly once
        native = stream._native
        state = native.make_state(stream.key, stream.nonce)
        data = native.uniform(state, np.array(ring.moduli, dtype=lp.dtype),
                              ring.degree, lp.modulus_bits)
        stream.nonce = native.state_nonce(state)
        return data
    words = stream.random_words(ring.nmoduli * ring.degree, lp.dtype)
    data = words.reshape(ring.nmoduli, ring.degree).copy()
    mask = lp.dtype((1 << lp.modulus_bits) - 1)
    for cm in range(ring.nmoduli):
        p = lp.dtype(ring.moduli[cm])
        t = data[cm] & mask
        data[cm] = np.where(t >= p, t - p, t)
    return data


def sample_non_uniform(ring: Ring, stream: Salsa20Stream,
                       mode: non_uniform) -> np.ndarray:
    lp = ring.limb_params
    ub = int(mode.upper_bound)
    amp = int(mode.amplifier)
    for p in ring.moduli:
        if ub >= p:
            raise ValueError("upper_bound is larger than the modulus")
    rnd = stream.random_words(ring.degree, lp.dtype)
    span = 2 * ub - 1
    mask = lp.dtype((1 << span.bit_length()) - 1)
    t = (rnd & mask).astype(np.uint64)
    t = np.where(t >= span, t - span, t)
    neg = t >= ub
    data = np.empty((ring.nmoduli, ring.degree), dtype=lp.dtype)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        # wrapping value_type arithmetic, matching core.hpp:236,264
        vals = np.where(neg, p + t * amp - span * amp, t * amp)
        data[cm] = (vals & ((1 << lp.repr_bits) - 1)).astype(lp.dtype)
    return data


def sample_zo(ring: Ring, stream: Salsa20Stream, mode: ZO_dist) -> np.ndarray:
    lp = ring.limb_params
    rnd = np.frombuffer(stream.randombytes(ring.degree), dtype=np.uint8)
    hit = rnd <= np.uint8(mode.rho)
    bit = (rnd & 2).astype(np.uint64)
    data = np.empty((ring.nmoduli, ring.degree), dtype=lp.dtype)
    for cm in range(ring.nmoduli):
        pm = int(ring.moduli[cm]) - 1
        data[cm] = np.where(hit, pm + bit, 0).astype(lp.dtype)
    return data


def sample_hwt(ring: Ring, stream: Salsa20Stream, mode: hwt_dist) -> np.ndarray:
    lp = ring.limb_params
    n, h = ring.degree, int(mode.hwt)
    if not 0 < h <= n:
        raise ValueError("hwt must be in (0, degree]")
    hitted = list(range(h))
    buf = []           # queue of 64-bit words
    for k in range(h, n):
        reject = ((1 << 64) - 1) // k
        while True:
            if not buf:
                raw = stream.randombytes(h * 8)
                buf = list(np.frombuffer(raw, dtype="<u8"))
            pos = int(buf.pop(0))
            if pos <= reject * k:
                pos %= k
                break
        if pos < h:
            hitted[pos] = k
    hitted.sort()
    raw = stream.randombytes(h * 8)
    signs = np.frombuffer(raw, dtype="<u8")[:h]
    data = np.zeros((ring.nmoduli, ring.degree), dtype=lp.dtype)
    for cm in range(ring.nmoduli):
        pm = int(ring.moduli[cm]) - 1
        for j, pos in enumerate(hitted):
            data[cm][pos] = lp.dtype((pm + int(signs[j] & 2))
                                     & ((1 << lp.repr_bits) - 1))
    return data


def sample_gaussian(ring: Ring, stream: Salsa20Stream,
                    mode: gaussian) -> np.ndarray:
    lp = ring.limb_params
    noise = mode.fg_prng.get_noise(stream, ring.degree)  # signed ints
    if mode.amplifier != 1:
        noise = noise * int(mode.amplifier)
    data = np.empty((ring.nmoduli, ring.degree), dtype=lp.dtype)
    for cm in range(ring.nmoduli):
        p = int(ring.moduli[cm])
        data[cm] = np.where(noise < 0, p + noise, noise).astype(lp.dtype)
    return data


def sample(ring: Ring, mode, stream: Salsa20Stream) -> np.ndarray:
    if isinstance(mode, uniform):
        return sample_uniform(ring, stream)
    if isinstance(mode, non_uniform):
        return sample_non_uniform(ring, stream, mode)
    if isinstance(mode, ZO_dist):
        return sample_zo(ring, stream, mode)
    if isinstance(mode, hwt_dist):
        return sample_hwt(ring, stream, mode)
    if isinstance(mode, gaussian):
        return sample_gaussian(ring, stream, mode)
    raise TypeError(f"unknown sampler mode {mode!r}")

