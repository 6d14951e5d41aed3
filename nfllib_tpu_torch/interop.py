"""Carry the JAX package's state across to the port, as numpy arrays.

Nothing here imports jax: the JAX package's values arrive as the numpy
arrays it produces (`np.asarray(poly.data)`, the tuples of
`nfllib_tpu.ops.ntt_mxu._fused_tables` / `_fused_inv_tables` and
`nfllib_tpu.ops.ntt_mxu_u64._tables64`), so a test can show that the port
computes with the JAX package's values: `fused_tables_from_numpy` and
`fused_tables64_from_numpy` recover the four-step route's matrices and
twiddle (ops/ntt_mxu.py) from the JAX kernels' digit planes.
The distributed layer (parallel/ntt_dist.py) holds local blocks where the
JAX package holds one sharded global array: `column_block_from_numpy` cuts
a rank's input block out of the global coefficients, and
`gather_row_blocks` / `gather_column_blocks` join the ranks' outputs into
the global array the JAX package returns.
"""
from __future__ import annotations

import numpy as np

from .apps.lwe import LweKeys
from .poly import Poly, _to_storage
from .ring import DEFAULT_DEVICE, Ring, _np_shoup_vec
from .utils import static_log2


def _join_digits(planes, dbits):
    """[m, ndig, r, c] digits d_a (int8) -> [m, r, c] uint64
    sum_a d_a 2^(dbits a)."""
    acc = np.zeros(planes.shape[:1] + planes.shape[2:], dtype=np.int64)
    for a in range(planes.shape[1]):
        acc += planes[:, a].astype(np.int64) << (dbits * a)
    return acc.astype(np.uint64)


def _route_tables(w1, w2, dbits, tw, p, width):
    """(e1, e2, tw, tws) uint64, as the route's providers and twiddle
    give them: tws recomputed from tw at the route's Shoup width."""
    m = tw.shape[0]
    p = np.asarray(p, dtype=np.uint64).reshape(m)
    tw = np.asarray(tw).astype(np.uint64)
    tws = np.stack([_np_shoup_vec(tw[cm].reshape(-1), int(p[cm]), width)
                    .reshape(tw.shape[1:]) for cm in range(m)])
    return _join_digits(w1, dbits), _join_digits(w2, dbits), tw, tws


def fused_tables_from_numpy(tables):
    """The JAX package's u16/u32 _fused_tables / _fused_inv_tables tuple
    -> the route's (e1, e2, tw, tws) uint64 arrays (ops/ntt_mxu.py's
    providers ntt64_e1_*, ntt64_e2_* and _twiddle): each matrix is the sum
    of the digit planes of its unscaled plane W^(0), u32's balanced bytes
    sum_a d_a 2^(8a) (the left planes byte-interleaved, b = 0 every 4th
    column), u16's 7-bit digits d_0 + 2^7 d_1; tw as it is, tws at 32
    bits (the JAX u16 companion has 16)."""
    n1, n2, w1t, w2l, tw, _, _, _, _, p_vec = tables
    ndig = 4 if w2l.shape[1] == 16 else 2
    w1 = w1t[..., 0::4] if ndig == 4 else w1t[:, 0::ndig]
    return _route_tables(w1, w2l[:, 0::ndig], 8 if ndig == 4 else 7, tw,
                         p_vec, 32)


def fused_tables64_from_numpy(tables):
    """The JAX package's nfllib_tpu.ops.ntt_mxu_u64._tables64 tuple (its
    64-bit entries (hi, lo) uint32 pairs) -> the route's (e1, e2, tw, tws)
    uint64 arrays: each matrix the balanced bytes of its unscaled plane
    W^(0) summed, tw joined, tws at 64 bits."""
    n1, n2, w1l, w2l, tw, _, _, _, _, p_vec = tables

    def join(v):
        if isinstance(v, tuple):
            hi, lo = (np.asarray(a).astype(np.uint64) for a in v)
            return (hi << np.uint64(32)) | lo
        return np.asarray(v, dtype=np.uint64)
    return _route_tables(w1l[:, 0::8], w2l[:, 0::8], 8, join(tw),
                         join(p_vec), 64)


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
