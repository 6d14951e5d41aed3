"""NFLlib-compatible serialization (reference include/nfl/poly.hpp:178-191).

Port of nfllib_tpu/serialize.py.  The reference's manual serializer writes
the raw residue array, moduli-major, little-endian limbs, N =
nmoduli*degree words (poly.hpp:180-185), and its cereal binary archive of
the same C array is the identical byte string.  Both map onto this one
format.  Batched polys serialize as the concatenation of each batch
element's bytes.
"""
from __future__ import annotations

import numpy as np

from .poly import Poly
from .ring import DEFAULT_DEVICE, Ring


def serialize_poly(p: Poly) -> bytes:
    arr = p.numpy()
    return arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()


def deserialize_poly(ring: Ring, buf: bytes, batch=(),
                     device=DEFAULT_DEVICE) -> Poly:
    shape = tuple(batch) + ring.shape
    count = int(np.prod(shape))
    dt = np.dtype(ring.dtype).newbyteorder("<")
    arr = np.frombuffer(buf, dtype=dt, count=count).astype(ring.dtype)
    return Poly.from_numpy(ring, arr.reshape(shape), device)
