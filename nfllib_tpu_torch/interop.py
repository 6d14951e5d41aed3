"""Carry the JAX package's state across to the port, as numpy arrays.

Nothing here imports jax: the JAX package's values arrive as the numpy
arrays it produces (`np.asarray(poly.data)`, the tuples of
`nfllib_tpu.ops.ntt_mxu._fused_tables` / `_fused_inv_tables` and
`nfllib_tpu.ops.ntt_mxu_u64._tables64`), so a test can run the port on the
JAX package's tables and on its own and show both give the same result.
The distributed layer (parallel/ntt_dist.py) holds local blocks where the
JAX package holds one sharded global array: `column_block_from_numpy` cuts
a rank's input block out of the global coefficients, and
`gather_row_blocks` / `gather_column_blocks` join the ranks' outputs into
the global array the JAX package returns.
"""
from __future__ import annotations

import numpy as np

from .ops.ntt_mxu import fused_tables_from_numpy  # noqa: F401  (re-export)
from .ops.ntt_mxu_u64 import fused_tables64_from_numpy  # noqa: F401
from .apps.lwe import LweKeys
from .poly import Poly, _to_storage
from .ring import DEFAULT_DEVICE, Ring
from .utils import static_log2


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


def column_block_from_numpy(x, ring: Ring, rank: int, d: int, n1=None,
                            device=DEFAULT_DEVICE):
    """[..., m, n] residues (the JAX input of distributed_ntt_pow_phi) ->
    rank `rank`'s column block [..., m, n1, n2/d] of the [..., m, n1, n2]
    view, the port's input for that rank; n1 defaults as in ntt_dist."""
    x = np.asarray(x)
    if x.dtype != ring.dtype or x.shape[-2:] != ring.shape:
        raise TypeError(f"expected {np.dtype(ring.dtype)} [..., "
                        f"{ring.nmoduli}, {ring.degree}], got {x.dtype} "
                        f"{x.shape}")
    if n1 is None:
        n1 = 1 << (static_log2(ring.degree) // 2)
    n2 = ring.degree // n1
    w = n2 // d
    blk = x.reshape(x.shape[:-1] + (n1, n2))[..., rank * w:(rank + 1) * w]
    return _to_storage(blk, ring).to(device)


def _gather(blocks, axis):
    arrs = [b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
            for b in blocks]
    return np.concatenate(arrs, axis=axis)


def gather_row_blocks(blocks, ring: Ring) -> np.ndarray:
    """The ranks' row blocks [..., m, n1/d, n2] in rank order (the port's
    forward outputs) -> the global [..., m, n1, n2] four-step layout as
    unsigned residues, comparable with the JAX package's output."""
    return _gather(blocks, -2).view(ring.dtype)


def gather_column_blocks(blocks, ring: Ring) -> np.ndarray:
    """The ranks' column blocks [..., m, n1, n2/d] in rank order (the
    port's inverse outputs) -> the global [..., m, n] coefficients."""
    out = _gather(blocks, -1).view(ring.dtype)
    return out.reshape(out.shape[:-2] + (ring.degree,))
