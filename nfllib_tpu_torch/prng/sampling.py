"""Random polynomial samplers (reference include/nfl/core.hpp:145-391).

Port of the host (numpy) tier of nfllib_tpu/prng/sampling.py, `uniform`
only: it consumes a Salsa20Stream exactly like the reference's
fastrandombytes-driven sampler — one stream call of m*n*itemsize bytes, per
channel a mask to the modulus bit width then a single conditional subtract
(NOT rejection sampling, reference core.hpp:158-177) — so residue arrays
are byte-identical to the reference's for the same (key, nonce).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ring import Ring
from .salsa20 import Salsa20Stream


@dataclasses.dataclass(frozen=True)
class uniform:
    """Sampler mode tag (reference poly.hpp:42-67)."""


def sample_uniform(ring: Ring, stream: Salsa20Stream) -> np.ndarray:
    """[m, n] residues in the unsigned limb dtype."""
    lp = ring.limb_params
    words = stream.random_words(ring.nmoduli * ring.degree, lp.dtype)
    data = words.reshape(ring.nmoduli, ring.degree).copy()
    mask = lp.dtype((1 << lp.modulus_bits) - 1)
    for cm in range(ring.nmoduli):
        p = lp.dtype(ring.moduli[cm])
        t = data[cm] & mask
        data[cm] = np.where(t >= p, t - p, t)
    return data


def sample(ring: Ring, mode, stream: Salsa20Stream) -> np.ndarray:
    if isinstance(mode, uniform):
        return sample_uniform(ring, stream)
    raise TypeError(f"sampler mode {mode!r} is not ported")
