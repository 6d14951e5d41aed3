"""Carry the JAX package's state across to the port, as numpy arrays.

Nothing here imports jax: the JAX package's values arrive as the numpy
arrays it produces (`np.asarray(poly.data)`, the tuples of
`nfllib_tpu.ops.ntt_mxu._fused_tables` / `_fused_inv_tables` and
`nfllib_tpu.ops.ntt_mxu_u64._tables64`), so a test can run the port on the
JAX package's tables and on its own and show both give the same result.
"""
from __future__ import annotations

import numpy as np

from .ops.ntt_mxu import fused_tables_from_numpy  # noqa: F401  (re-export)
from .ops.ntt_mxu_u64 import fused_tables64_from_numpy  # noqa: F401
from .apps.lwe import LweKeys
from .poly import Poly
from .ring import DEFAULT_DEVICE, Ring


def poly_from_numpy(arr, ring: Ring, device=DEFAULT_DEVICE) -> Poly:
    """[..., m, n] uint16/uint32/uint64 residues (the JAX Poly.data)
    -> Poly."""
    arr = np.asarray(arr)
    if arr.dtype != ring.dtype:
        raise TypeError(f"expected {np.dtype(ring.dtype)} residues for "
                        f"{ring.limb}, got {arr.dtype}")
    return Poly.from_numpy(ring, arr, device)


def poly_to_numpy(poly: Poly) -> np.ndarray:
    """Poly -> [..., m, n] uint16/uint32/uint64 residues, byte-equal to
    storage."""
    return poly.numpy()


def lwe_keys_from_numpy(s, sprime, pka, pkb, ring: Ring,
                        device=DEFAULT_DEVICE) -> LweKeys:
    """The JAX package's LWE keys as numpy residue arrays (np.asarray of
    `keys.s.data`, `keys.sprime.data`, `keys.pka.data`, `keys.pkb.data`)
    -> the port's LweKeys on `device`, so that ciphertexts made by either
    package decrypt in the other."""
    return LweKeys(*(poly_from_numpy(a, ring, device)
                     for a in (s, sprime, pka, pkb)))
